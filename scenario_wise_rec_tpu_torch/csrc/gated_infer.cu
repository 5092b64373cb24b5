// Fused eval forward of EPNet for NVIDIA Hopper (sm_90a), f32. (PPNet's and
// AdaSparse's, the others of the family, are ppnet_infer.cu and
// adasparse_infer.cu.)
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/gated_infer.py:
// epnet_fused_infer: h = relu([s ‖ a] W1 + b1), gate = gemma * sigmoid(h W2 +
// b2), out = sigmoid((a * gate) Wo + bo). A product with a concatenation,
// [s ‖ a] W, is split as s W[:S] + a W[S:] (the kAccum stages of
// fused_mlp.cuh): no concatenated activation exists.
//
// What bounds it on this card: arithmetic. At the Ali-CCP shape (S 16, A
// 360, W1 376 -> 360, W2 360 -> 360) a row costs ~265k multiply-adds and
// moves ~1.5 KB, so a 4096-row batch is 2.2 GFLOP against ~7 MB: the FP32
// SIMT peak bounds it, not HBM.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16). The inputs stay in dynamic shared memory for
// the whole stack, as the gate needs them: it multiplies a. Activations live
// in shared memory too; weights stream from L2. The stages take the tile's
// rows 8 at a time (no domain).
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

constexpr int SR = fused::kSharedRows;

// ---------------------------------------------------------------------------
// EPNet
// ---------------------------------------------------------------------------

struct EpnetArgs {
  const float* sce;  // [B, S]
  const float* agn;  // [B, A]
  float* out;        // [B]
  int B, S, A, H, tb, ld_s, ld_a, ld_h;
  float gemma;
  Stage st[3];  // gate l1 (W [S + A, H]), gate l2 (W [H, A]), head (W [A, 1])
};

__global__ void __launch_bounds__(fused::kThreads)
epnet_fused_infer_kernel(const __grid_constant__ EpnetArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, S = p.S, A = p.A, H = p.H;
  float* s = smem;                          // [tb, ld_s]
  float* a = s + (size_t)tb * p.ld_s;       // [tb, ld_a]
  float* h = a + (size_t)tb * p.ld_a;       // [tb, ld_h]
  float* z = h + (size_t)tb * p.ld_h;       // [tb, ld_a]
  float* logit = z + (size_t)tb * p.ld_a;   // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.sce, nullptr, row0, rows, S, 1, s, p.ld_s, tb, did_s);
  fused::stage_rows(p.agn, row0, rows, A, a, p.ld_a, tb);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  // h = relu(s W1[:S] + a W1[S:] + b1)
  const Stage& l1 = p.st[0];
  fused::dense<SR, false>(all, Act{s, 0, p.ld_s}, S, l1.w, 0, nullptr, 0, H, h, p.ld_h);
  __syncthreads();
  fused::dense<SR, true, true>(all, Act{a, 0, p.ld_a}, A, l1.w + (size_t)S * H, 0, l1.b, 0,
                               H, h, p.ld_h);
  __syncthreads();
  // z = a * gemma * sigmoid(h W2 + b2)
  fused::dense<SR, false>(all, Act{h, 0, p.ld_h}, H, p.st[1].w, 0, p.st[1].b, 0, A, z,
                          p.ld_a);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * A; i += blockDim.x) {
    const size_t o = (size_t)(i / A) * p.ld_a + i % A;
    z[o] = a[o] * (p.gemma * fused::sigmoid(z[o]));
  }
  __syncthreads();
  fused::dense<SR, false>(all, Act{z, 0, p.ld_a}, A, p.st[2].w, 0, p.st[2].b, 0, 1, logit, 1);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

bool rows_ok(int B, int block_rows) {
  return B >= 0 && block_rows >= fused::kSharedRows && block_rows <= fused::kMaxBlockRows &&
         block_rows % fused::kSharedRows == 0;
}

size_t smem_for(size_t floats, int block_rows) {
  return (floats + fused::round4(block_rows)) * sizeof(float) +
         (size_t)fused::group_ints(block_rows) * sizeof(int);
}

}  // namespace

extern "C" {

// w_ptrs/b_ptrs are host arrays of device pointers, one per stage, in the
// order of EpnetArgs' comment; dims: (K, N) per stage. Writes the dynamic
// shared memory a block needs to *smem_bytes and returns a cudaError_t.

int epnet_fused_infer_f32(const void* sce, const void* agn, void* out, int B, int S, int A,
                          float gemma, const void* w_ptrs, const void* b_ptrs,
                          const void* dims, int block_rows, void* stream,
                          size_t* smem_bytes) {
  EpnetArgs p = {};
  Stage st[fused::kMaxStages];
  if (!rows_ok(B, block_rows) || S < 1 || A < 1 || !fused::fill_stages(st, 3, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  const int H = st[0].N;
  if (st[0].K != S + A || st[1].K != H || st[1].N != A || st[2].K != A || st[2].N != 1 ||
      st[0].b == nullptr || st[1].b == nullptr || st[2].b == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) p.st[i] = st[i];
  p.sce = static_cast<const float*>(sce);
  p.agn = static_cast<const float*>(agn);
  p.out = static_cast<float*>(out);
  p.B = B; p.S = S; p.A = A; p.H = H; p.tb = block_rows; p.gemma = gemma;
  p.ld_s = fused::round4(S);
  p.ld_a = fused::round4(A);
  p.ld_h = fused::round4(H);
  const size_t tb = block_rows;
  const size_t smem = smem_for(tb * (p.ld_s + 2 * (size_t)p.ld_a + p.ld_h), block_rows);
  *smem_bytes = smem;
  return fused::launch(epnet_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
