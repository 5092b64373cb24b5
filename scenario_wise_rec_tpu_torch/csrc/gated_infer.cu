// Fused eval forwards of EPNet and AdaSparse for NVIDIA Hopper (sm_90a), f32.
// (PPNet's, the third of the family, is ppnet_infer.cu.)
//
// Replaces two TPU kernels of
// scenario_wise_rec_tpu/ops/pallas/gated_infer.py:
// - epnet_fused_infer: h = relu([s ‖ a] W1 + b1), gate = gemma *
//   sigmoid(h W2 + b2), out = sigmoid((a * gate) Wo + bo);
// - adasparse_fused_infer: a' = prune([s ‖ a] P_0) * a, then each layer i:
//   h_i = relu(h_{i-1} W_i + b_i) (h_0 = [s ‖ a']) * prune([s ‖ h_i] P_i+1);
//   out = sigmoid(h Wf + bf). prune(v) is sign(sigmoid(v) - eps)
//   (Binarization) or beta * sigmoid(v) * sign(beta * sigmoid(v) - eps)
//   (Scaling, Fusion; alpha is folded into P outside the kernel).
// BatchNorm is folded into W_i, b_i outside the kernel (folding.py). A
// product with a concatenation, [s ‖ a] W, is split as s W[:S] + a W[S:]
// (the kAccum stages of fused_mlp.cuh): no concatenated activation exists.
//
// What bounds them on this card: arithmetic. At the Ali-CCP shapes a row
// costs ~265k (EPNet: S 16, A 360, W1 376 -> 360, W2 360 -> 360) and ~363k
// (AdaSparse: S 16, A 352, layers [256,...,8], a pruner after each)
// multiply-adds and moves ~1.5 KB, so a 4096-row batch is 2.2-3.0 GFLOP
// against ~7 MB: the FP32 SIMT peak bounds them, not HBM.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16). The inputs stay in dynamic shared memory for
// the whole stack, as the gates need them: EPNet's gate multiplies a, every
// AdaSparse pruner reads s. Activations live in shared memory too; weights
// stream from L2. The stages take the tile's rows 8 at a time (no domain).
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

constexpr int SR = fused::kSharedRows;

// sign() that is 0 at 0, as jnp.sign and torch.sign are (copysignf is not)
__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }

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

constexpr int kMaxLayers = 30;

// ---------------------------------------------------------------------------
// AdaSparse
// ---------------------------------------------------------------------------

struct AdasparseArgs {
  const float* sce;  // [B, S]
  const float* agn;  // [B, A]
  float* out;        // [B]
  int B, S, A, n_lay, tb, form, ld_s, ld_a, ld_h;
  float eps, beta;
  // pruners (W [S + h_i, h_i], no bias), layers (W [in, out]), head
  Stage st[2 * kMaxLayers + 2];
};

// x <- prune(s P[:S] + x P[S:]) * x over the first N columns of x [tb, ld_x],
// with v [tb, ld_v] as scratch
__device__ void prune(const AdasparseArgs& p, const Groups& all, int rows, const float* s,
                      const Stage& P, float* x, int ld_x, float* v, int ld_v) {
  const int N = P.N;
  fused::dense<SR, false>(all, Act{s, 0, p.ld_s}, p.S, P.w, 0, nullptr, 0, N, v, ld_v);
  __syncthreads();
  fused::dense<SR, false, true>(all, Act{x, 0, ld_x}, N, P.w + (size_t)p.S * N, 0, nullptr,
                                0, N, v, ld_v);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    const int r = i / N, c = i % N;
    const float u = v[(size_t)r * ld_v + c];
    float w;
    if (p.form == 0) {
      w = sgn(fused::sigmoid(u) - p.eps);
    } else {
      const float vo = p.beta * fused::sigmoid(u);
      w = vo * sgn(vo - p.eps);
    }
    float* e = x + (size_t)r * ld_x + c;
    *e = w * *e;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(fused::kThreads)
adasparse_fused_infer_kernel(const __grid_constant__ AdasparseArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, S = p.S, A = p.A, n = p.n_lay;
  // hb[0], hb[1] hold h_i and h_i-1; pruner i + 1 takes the buffer of
  // h_i-1, which layer i has consumed, as scratch, and pruner 0 the space of
  // both ([tb, ld_a] in it, before layer 0 writes hb[0])
  float* s = smem;                             // [tb, ld_s]
  float* a = s + (size_t)tb * p.ld_s;          // [tb, ld_a]
  float* hb[2];                                // each [tb, ld_h]
  hb[0] = a + (size_t)tb * p.ld_a;
  hb[1] = hb[0] + (size_t)tb * p.ld_h;
  const size_t scratch = (size_t)tb * (p.ld_a > 2 * p.ld_h ? p.ld_a : 2 * p.ld_h);
  float* logit = hb[0] + scratch;              // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.sce, nullptr, row0, rows, S, 1, s, p.ld_s, tb, did_s);
  fused::stage_rows(p.agn, row0, rows, A, a, p.ld_a, tb);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  const Stage* pruners = p.st;
  const Stage* layers = p.st + n + 1;
  const Stage& head = p.st[2 * n + 1];
  prune(p, all, rows, s, pruners[0], a, p.ld_a, hb[0], p.ld_a);  // a <- prune(...) * a
  Act h{nullptr, 0, 0};
  for (int i = 0; i < n; ++i) {
    const Stage& L = layers[i];
    float* o = hb[i % 2];
    if (i == 0) {  // relu(s W[:S] + a W[S:] + b)
      fused::dense<SR, false>(all, Act{s, 0, p.ld_s}, S, L.w, 0, nullptr, 0, L.N, o, p.ld_h);
      __syncthreads();
      fused::dense<SR, true, true>(all, Act{a, 0, p.ld_a}, A, L.w + (size_t)S * L.N, 0, L.b,
                                   0, L.N, o, p.ld_h);
    } else {
      fused::dense<SR, true>(all, h, L.K, L.w, 0, L.b, 0, L.N, o, p.ld_h);
    }
    __syncthreads();
    prune(p, all, rows, s, pruners[i + 1], o, p.ld_h, hb[(i + 1) % 2], p.ld_h);
    h = Act{o, 0, p.ld_h};
  }
  if (n == 0) {  // the head on [s ‖ a]
    fused::dense<SR, false>(all, Act{s, 0, p.ld_s}, S, head.w, 0, nullptr, 0, 1, logit, 1);
    __syncthreads();
    fused::dense<SR, false, true>(all, Act{a, 0, p.ld_a}, A, head.w + S, 0, head.b, 0, 1,
                                  logit, 1);
  } else {
    fused::dense<SR, false>(all, h, head.K, head.w, 0, head.b, 0, 1, logit, 1);
  }
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

// Each function: w_ptrs/b_ptrs are host arrays of device pointers, one per
// stage, in the order of its Args' comment (a null bias adds nothing);
// dims: (K, N) per stage. Each writes the dynamic shared memory a block
// needs to *smem_bytes and returns a cudaError_t.

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

int adasparse_fused_infer_f32(const void* sce, const void* agn, void* out, int B, int S,
                              int A, int n_lay, int form, float eps, float beta,
                              const void* w_ptrs, const void* b_ptrs, const void* dims,
                              int block_rows, void* stream, size_t* smem_bytes) {
  AdasparseArgs p = {};
  if (!rows_ok(B, block_rows) || S < 1 || A < 1 || n_lay < 0 || n_lay > kMaxLayers ||
      form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  Stage st[2 * kMaxLayers + 2];
  const int n = 2 * n_lay + 2;
  if (n > fused::kMaxStages || !fused::fill_stages(st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  // pruner 0 on [s ‖ a]; layer i from [s ‖ a] (i = 0) or h; pruner i + 1 on [s ‖ h_i]
  if (st[0].K != S + A || st[0].N != A) return (int)cudaErrorInvalidValue;
  int width = S + A, ld_h = 1;
  for (int i = 0; i < n_lay; ++i) {
    const Stage &L = st[n_lay + 1 + i], &P = st[i + 1];
    if (L.K != width || L.b == nullptr || P.K != S + L.N || P.N != L.N)
      return (int)cudaErrorInvalidValue;
    width = L.N;
    ld_h = L.N > ld_h ? L.N : ld_h;
  }
  if (st[n - 1].K != width || st[n - 1].N != 1 || st[n - 1].b == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) p.st[i] = st[i];
  p.sce = static_cast<const float*>(sce);
  p.agn = static_cast<const float*>(agn);
  p.out = static_cast<float*>(out);
  p.B = B; p.S = S; p.A = A; p.n_lay = n_lay; p.tb = block_rows; p.form = form;
  p.eps = eps; p.beta = beta;
  p.ld_s = fused::round4(S);
  p.ld_a = fused::round4(A);
  p.ld_h = fused::round4(ld_h);
  const size_t tb = block_rows;
  const size_t scratch = p.ld_a > 2 * p.ld_h ? p.ld_a : 2 * p.ld_h;
  const size_t smem = smem_for(tb * (p.ld_s + (size_t)p.ld_a + scratch), block_rows);
  *smem_bytes = smem;
  return fused::launch(adasparse_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
