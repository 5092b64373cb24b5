// One segment of HAMUR's eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/hamur_infer.py:
// _segment (the pallas_call that hamur_fused_infer runs once per segment).
// HAMUR's adapters normalise with the current batch's statistics, a
// reduction across rows in the middle of the network, so the stack is cut at
// each adapter into segments; the statistics are taken in PyTorch between
// them. One launch runs one segment, in one of three forms:
//
//   first  (x = emb [B, F]): for every domain d, the relu blocks
//          h_d = relu(... relu(x W_d + b_d) ...) (BatchNorm folded), then the
//          adapter on h_d;
//   middle (x = h_res [B, D, F], t_pre [B, D, F]): for every domain d,
//          x_d = (t_pre_d - mean_d) * scale_d + shift_d + h_res_d (the previous
//          adapter's norm as an affine, and its residual), the blocks, the
//          adapter;
//   final  (x as first or middle): the same input and blocks for the row's
//          own domain d = clip(domain_id, 0, D-1) only, then its width-1
//          Linear and the sigmoid: probs [B].
//
// The adapter of a row b and domain d, with H_b = hyper[b] [k, k]:
//   p = h_d U_down; q = p H_b; t = sigmoid(q V_down + b_down);
//   p = t U_up;     q = p H_b; t_pre = q V_up + b_up          ([F_out])
// and the first and middle forms write t_pre [B, D, F_out] and the blocks'
// output h [B, D, F_out]; the norm of t_pre is the next segment's affine.
//
// What bounds it on this card: arithmetic. At HamurLarge's Ali-CCP shape
// (F = 376, blocks [256,128,64,64,32,16 | 8], k = 65, 3 domains) the first
// segment costs 431,616 multiply-adds a row in the blocks (every domain: each
// domain's branch is normalised over all rows) and 44,070 in the adapters,
// the second 41,334; a 4096-row batch is ~4.2 GFLOP against ~148 MB (the
// hyper matrix H, 16,900 B a row, read once by each adapter segment).
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16), all activations in dynamic shared memory. The
// blocks run domain by domain over the tile's rows, 8 at a time, with the
// domain's weights streaming from L2. The adapter walks the tile `hr` rows at
// a time (as many as ~36 KB of H allow: 2 at k = 65): their H rows are read
// from device memory once, into shared memory, and serve every domain and
// both the down- and the up-projection. The final form groups rows by domain
// (4 at a time), so a row pays for its own domain only. No tensor cores yet.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

constexpr int kHyperBytes = 36 * 1024;  // shared memory for the H rows of one pass

struct Args {
  const float* x;       // emb [B, F] (first) or h_res [B, D, F]
  const float* t_pre;   // [B, D, F] or null (first)
  const float* mean;    // [D, F] or null (first)
  const float* scale;   // [D, F] or null (first)
  const float* shift;   // [D, F] or null (first)
  const float* hyper;   // [B, k, k] or null (final)
  const float* u_down;  // [F_out, k]
  const float* v_down;  // [k, mid]
  const float* b_down;  // [mid]
  const float* u_up;    // [mid, k]
  const float* v_up;    // [k, F_out]
  const float* b_up;    // [F_out]
  const int* did;       // [B] (final)
  float* out_t;         // [B, D, F_out] adapter output before its norm
  float* out_h;         // [B, D, F_out] the blocks' output
  float* out_p;         // [B] probs (final)
  int B, F, D, tb, first, final_, n_st, w_out, k, mid, hr;
  int ld_x, ld, ldh;    // row strides of the input tile, the buffers, the blocks' output
  // offsets (floats) into shared memory
  size_t o_buf0, o_buf1, o_hb, o_h, o_p, o_q, o_t, o_logit, o_ints;
  Stage st[fused::kMaxStages];  // block stages, then the final head
};

// sQ[i, d, :] = sP[i, d, :] H_i for the pass's n rows: H_i is row i's
// hyper matrix in shared memory, read by every domain.
__device__ void times_hyper(const float* sP, const float* sH, float* sQ, int n, int D, int k) {
  const int kk = k * k;
  for (int i = threadIdx.x; i < n * D * k; i += blockDim.x) {
    const int ri = i / (D * k), j = i % k;
    const float* pv = sP + (size_t)(i / k) * k;
    const float* H = sH + (size_t)ri * kk + j;
    float acc = 0.f;
    for (int l = 0; l < k; ++l) acc = fmaf(pv[l], H[(size_t)l * k], acc);
    sQ[i] = acc;
  }
}

// out[i, d, c] = act(sum_j in[i, d, j] W[j, c] + b[c]) for the pass's n rows
// and every domain; in [n, D, K] and out [n, D, N] are dense in shared memory.
template <bool kSigmoid>
__device__ void small_dense(const float* in, int K, const float* __restrict__ W,
                            const float* __restrict__ b, int N, float* out, int n, int D) {
  for (int i = threadIdx.x; i < n * D * N; i += blockDim.x) {
    const int c = i % N;
    const float* v = in + (size_t)(i / N) * K;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(v[j], __ldg(W + (size_t)j * N + c), acc);
    if (b != nullptr) acc += __ldg(b + c);
    out[i] = kSigmoid ? fused::sigmoid(acc) : acc;
  }
}

__global__ void __launch_bounds__(fused::kThreads)
hamur_segment_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, D = p.D, F = p.F, ld_x = p.ld_x;
  const bool first = p.first != 0, fin = p.final_ != 0;
  float* xs = smem;  // [nx, tb, ld_x]: one input tile, or one per domain (middle)
  float* buf0 = smem + p.o_buf0;
  float* buf1 = smem + p.o_buf1;
  int* did_s = reinterpret_cast<int*>(smem + p.o_ints);

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  for (int r = threadIdx.x; r < tb; r += blockDim.x) {
    const int d = (fin && r < rows) ? p.did[row0 + r] : 0;
    did_s[r] = min(max(d, 0), D - 1);
  }
  __syncthreads();
  // the input tile: the embedding rows, or each domain's (one domain's in
  // the final form) norm affine plus residual; zeros past the batch
  const int nx = (first || fin) ? 1 : D;
  for (int i = threadIdx.x; i < nx * tb * ld_x; i += blockDim.x) {
    const int c = i % ld_x, r = (i / ld_x) % tb;
    float v = 0.f;
    if (r < rows && c < F) {
      if (first) {
        v = p.x[(size_t)(row0 + r) * F + c];
      } else {
        const int d = fin ? did_s[r] : i / (tb * ld_x);
        const size_t g = ((size_t)(row0 + r) * D + d) * F + c;
        const size_t dc = (size_t)d * F + c;
        v = (p.t_pre[g] - p.mean[dc]) * p.scale[dc] + p.shift[dc] + p.x[g];
      }
    }
    xs[i] = v;
  }
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  if (fin) {
    // the row's own domain: blocks, head, sigmoid
    float* logit = smem + p.o_logit;
    Act h = fused::chain<fused::kDomainRows, 1>(own, Act{xs, 0, ld_x}, p.st, p.n_st, 0, 1,
                                                buf0, buf1, p.ld, rows);
    fused::chain<fused::kDomainRows, 0>(own, h, p.st + p.n_st, 1, 0, 1, buf0, buf1, p.ld,
                                        rows, logit, 1);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      p.out_p[row0 + r] = fused::sigmoid(logit[r]);
    return;
  }

  // every domain's blocks over all rows; hd: where domain d's output lies
  Act hd{xs, first ? 0 : (size_t)tb * ld_x, ld_x};
  if (p.n_st > 0) {
    float* hb = smem + p.o_hb;  // [D, tb, ldh]
    for (int d = 0; d < D; ++d)
      fused::chain<fused::kSharedRows, 1>(all, Act{xs + d * hd.dstride, 0, ld_x}, p.st,
                                          p.n_st, d, 0, buf0, buf1, p.ld, rows,
                                          hb + (size_t)d * tb * p.ldh, p.ldh);
    hd = Act{hb, (size_t)tb * p.ldh, p.ldh};
  }
  const int W = p.w_out, k = p.k, mid = p.mid;
  for (int i = threadIdx.x; i < rows * D * W; i += blockDim.x) {
    const int r = i / (D * W), d = (i / W) % D, c = i % W;
    p.out_h[(size_t)row0 * D * W + i] = hd.p[d * hd.dstride + (size_t)r * hd.ld + c];
  }

  // the adapter, hr rows at a time
  float* sH = smem + p.o_h;  // [hr, k, k]
  float* sP = smem + p.o_p;  // [hr, D, k]
  float* sQ = smem + p.o_q;  // [hr, D, k]
  float* sT = smem + p.o_t;  // [hr, D, mid]
  const size_t kk = (size_t)k * k;
  for (int r0 = 0; r0 < rows; r0 += p.hr) {
    const int n = min(p.hr, rows - r0);
    const float* hy = p.hyper + (size_t)(row0 + r0) * kk;
    for (size_t i = threadIdx.x; i < n * kk; i += blockDim.x) sH[i] = __ldg(hy + i);
    for (int i = threadIdx.x; i < n * D * k; i += blockDim.x) {
      const int j = i % k, d = (i / k) % D, r = r0 + i / (D * k);
      const float* h = hd.p + d * hd.dstride + (size_t)r * hd.ld;
      float acc = 0.f;
      for (int c = 0; c < W; ++c) acc = fmaf(h[c], __ldg(p.u_down + (size_t)c * k + j), acc);
      sP[i] = acc;
    }
    __syncthreads();
    times_hyper(sP, sH, sQ, n, D, k);
    __syncthreads();
    small_dense<true>(sQ, k, p.v_down, p.b_down, mid, sT, n, D);
    __syncthreads();
    small_dense<false>(sT, mid, p.u_up, nullptr, k, sP, n, D);
    __syncthreads();
    times_hyper(sP, sH, sQ, n, D, k);
    __syncthreads();
    small_dense<false>(sQ, k, p.v_up, p.b_up, W, p.out_t + (size_t)(row0 + r0) * D * W, n, D);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x, t_pre, mean, scale, shift, hyper, did: as Args (null where the form has none);
// adapter: a host array of 6 device pointers u_down, v_down, b_down, u_up,
// v_up, b_up (ignored in the final form). w_ptrs/b_ptrs: host arrays of
// device pointers, one per stage, the block stages then (final) the head;
// dims: (K, N) per stage. Writes the dynamic shared memory a block needs to
// *smem_bytes. Returns a cudaError_t.
int hamur_segment_f32(const void* x, const void* t_pre, const void* mean, const void* scale,
                      const void* shift, const void* hyper, const void* adapter,
                      const void* did, void* out_t, void* out_h, void* out_p, int B, int F,
                      int D, int k, int mid,
                      int first, int final_, int n_st, const void* w_ptrs,
                      const void* b_ptrs, const void* dims, int block_rows, void* stream,
                      size_t* smem_bytes) {
  Args p = {};
  const int n = n_st + (final_ ? 1 : 0);
  if (B < 0 || F < 1 || D < 1 || n_st < 0 || block_rows < fused::kSharedRows ||
      block_rows > fused::kMaxBlockRows || block_rows % fused::kSharedRows != 0 ||
      !fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  int width = F, max_w = 4;
  for (int s = 0; s < n; ++s) {
    if (p.st[s].K != width) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  const int w_out = n_st > 0 ? p.st[n_st - 1].N : F;
  if (final_ ? width != 1 : (k < 1 || mid < 1)) return (int)cudaErrorInvalidValue;
  const int tb = block_rows;
  p.x = static_cast<const float*>(x);
  p.t_pre = static_cast<const float*>(t_pre);
  p.mean = static_cast<const float*>(mean);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.hyper = static_cast<const float*>(hyper);
  p.did = static_cast<const int*>(did);
  p.out_t = static_cast<float*>(out_t);
  p.out_h = static_cast<float*>(out_h);
  p.out_p = static_cast<float*>(out_p);
  if (!final_) {
    const float* const* a = static_cast<const float* const*>(adapter);
    p.u_down = a[0]; p.v_down = a[1]; p.b_down = a[2];
    p.u_up = a[3]; p.v_up = a[4]; p.b_up = a[5];
  }
  p.B = B; p.F = F; p.D = D; p.tb = tb;
  p.first = first ? 1 : 0; p.final_ = final_ ? 1 : 0; p.n_st = n_st;
  p.w_out = w_out; p.k = final_ ? 0 : k; p.mid = final_ ? 0 : mid;
  p.ld_x = fused::round4(F);
  p.ld = fused::round4(max_w);
  p.ldh = fused::round4(w_out);
  const int nx = (first || final_) ? 1 : D;
  size_t off = (size_t)nx * tb * p.ld_x;
  p.o_buf0 = off; off += (size_t)tb * p.ld;
  p.o_buf1 = off; off += (size_t)tb * p.ld;
  if (final_) {
    p.o_logit = off; off += fused::round4(tb);
  } else {
    const size_t kk = (size_t)k * k;
    p.hr = (int)(kHyperBytes / (kk * sizeof(float)));
    p.hr = p.hr < 1 ? 1 : (p.hr > tb ? tb : p.hr);
    if (n_st > 0) { p.o_hb = off; off += (size_t)D * tb * p.ldh; }
    p.o_h = off; off += fused::round4((int)(p.hr * kk));
    p.o_p = off; off += fused::round4(p.hr * D * k);
    p.o_q = off; off += fused::round4(p.hr * D * k);
    p.o_t = off; off += fused::round4(p.hr * D * mid);
  }
  p.o_ints = off;
  const size_t smem = off * sizeof(float) + (size_t)fused::group_ints(tb) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(hamur_segment_kernel, p, B, tb, smem, stream);
}

}  // extern "C"
