// Fused M2M eval forward after the transformer, for NVIDIA Hopper (sm_90a),
// f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/m2m_infer.py:
// m2m_fused_infer. M2M's transformer attends across the rows of a batch and
// stays in PyTorch; everything after it is per row:
//   scen, task = leakyrelu MLPs of the scenario embedding (width E),
//   x_n        = leakyrelu expert n of the transformer output (nE experts),
//   vw, vb     = leakyrelu MLPs of scen: the row's own [2E, 2E] meta matrix
//                (flat, 4E^2) and its bias,
//   score_n    = sum_f lrelu(vb[f] + sum_e [x_n ‖ task][e] vw[e, f]) v[f],
//   alpha      = softmax over the experts, rt = sum_n alpha_n x_n,
//   tw, tb     = leakyrelu MLPs of scen: the row's own [E, E] tower matrix
//                and bias,
//   h          = lrelu(tb + rt + rt tw), then the relu output MLP, its
//                head and the sigmoid.
// There is no domain select: every row runs the same weights, so every
// dense stage is a shared-weight stage (fused_mlp.cuh's kSharedRows groups).
//
// What bounds it on this card: arithmetic. At M2M's Ali-CCP shape (F = 376,
// Fd = 16, E = 16, 4 experts, output MLP [64, 32]) a row costs ~53.5k
// multiply-adds (the experts 24k, vw 16k, the meta-attention 4k) against
// ~1.6 KB moved, so a 4096-row batch is ~0.44 GFLOP against ~6.4 MB: the
// FP32 SIMT peak bounds it.
//
// What the design does about it: one block of 256 threads owns tb rows
// (default 8). The tile's transformer output and scenario embedding, every
// hyper-MLP output (the row's 4 KB meta matrix too), the experts' outputs
// and the scores live in dynamic shared memory; weights stream from L2. The
// shared-weight stages take the tile's rows 8 at a time (fused_mlp.cuh). The
// meta-attention gives one warp a (row, expert) pair: lane f owns output
// column f of the row's own meta matrix, reading it conflict-free, and the
// score is a warp sum. Shared memory bounds tb: 24 rows at Ali-CCP widths.
//
// The weights come as one list of stages in the order of the TPU kernel's
// argument list: the expert, task, scenario, vw, vb, tw, tb and output
// chains, then the head. v [2E, 1] comes apart.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

constexpr int kMaxChain = 8;  // stages of one chain
enum { kExpert, kTask, kScen, kVw, kVb, kTw, kTb, kOut, kChains };

struct Args {
  const float* t_out;  // [B, F]
  const float* dom;    // [B, Fd]
  const float* v;      // [2E]
  float* out;          // [B]
  int B, F, Fd, nE, E, tb;
  int cnt[kChains];
  int ld_f, ld_d, ld_e, ld_vw, ld_vb, ld_tw, ld_w, ld_n;
  Stage st[kChains * kMaxChain + 1];
};

__global__ void __launch_bounds__(fused::kThreads)
m2m_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int SR = fused::kSharedRows;
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, E = p.E, nE = p.nE, E2 = 2 * p.E;
  float* t_s = smem;                                      // [tb, ld_f]
  float* d_s = t_s + (size_t)tb * p.ld_f;                 // [tb, ld_d]
  float* scen_s = d_s + (size_t)tb * p.ld_d;              // [tb, ld_e]
  float* task_s = scen_s + (size_t)tb * p.ld_e;           // [tb, ld_e]
  float* ex_s = task_s + (size_t)tb * p.ld_e;             // [nE, tb, ld_e]
  float* vw_s = ex_s + (size_t)nE * tb * p.ld_e;          // [tb, ld_vw]
  float* vb_s = vw_s + (size_t)tb * p.ld_vw;              // [tb, ld_vb]
  float* tw_s = vb_s + (size_t)tb * p.ld_vb;              // [tb, ld_tw]
  float* tbias_s = tw_s + (size_t)tb * p.ld_tw;           // [tb, ld_e]
  float* pp0 = tbias_s + (size_t)tb * p.ld_e;             // [tb, ld_w]
  float* pp1 = pp0 + (size_t)tb * p.ld_w;                 // [tb, ld_w]
  float* score_s = pp1 + (size_t)tb * p.ld_w;             // [tb, ld_n]
  float* rt_s = score_s + (size_t)tb * p.ld_n;            // [tb, ld_e]
  float* h_s = rt_s + (size_t)tb * p.ld_e;                // [tb, ld_e]
  float* logit = h_s + (size_t)tb * p.ld_e;               // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_rows(p.t_out, row0, rows, p.F, t_s, p.ld_f, tb);
  fused::stage_rows(p.dom, row0, rows, p.Fd, d_s, p.ld_d, tb);
  for (int r = threadIdx.x; r < tb; r += blockDim.x) did_s[r] = 0;  // no domains
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  const Stage* first[kChains + 1];  // each chain's first stage; the head last
  first[0] = p.st;
  for (int c = 0; c < kChains; ++c) first[c + 1] = first[c] + p.cnt[c];

  const Act dom{d_s, 0, p.ld_d};
  fused::chain<SR, 3>(all, dom, first[kScen], p.cnt[kScen], 0, 0, pp0, pp1, p.ld_w, rows,
                      scen_s, p.ld_e);
  fused::chain<SR, 3>(all, dom, first[kTask], p.cnt[kTask], 0, 0, pp0, pp1, p.ld_w, rows,
                      task_s, p.ld_e);
  for (int n = 0; n < nE; ++n)
    fused::chain<SR, 3>(all, Act{t_s, 0, p.ld_f}, first[kExpert], p.cnt[kExpert], n, 0, pp0,
                        pp1, p.ld_w, rows, ex_s + (size_t)n * tb * p.ld_e, p.ld_e);
  const Act scen{scen_s, 0, p.ld_e};
  fused::chain<SR, 3>(all, scen, first[kVw], p.cnt[kVw], 0, 0, pp0, pp1, p.ld_w, rows, vw_s,
                      p.ld_vw);
  fused::chain<SR, 3>(all, scen, first[kVb], p.cnt[kVb], 0, 0, pp0, pp1, p.ld_w, rows, vb_s,
                      p.ld_vb);
  fused::chain<SR, 3>(all, scen, first[kTw], p.cnt[kTw], 0, 0, pp0, pp1, p.ld_w, rows, tw_s,
                      p.ld_tw);
  fused::chain<SR, 3>(all, scen, first[kTb], p.cnt[kTb], 0, 0, pp0, pp1, p.ld_w, rows,
                      tbias_s, p.ld_e);

  // meta-attention: one warp per (row, expert), lane f on column f of the
  // row's own meta matrix, the score a warp sum (the loop is warp-uniform)
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int item = threadIdx.x >> 5; item < rows * nE; item += n_warps) {
    const int r = item / nE, n = item % nE;
    const float* x = ex_s + ((size_t)n * tb + r) * p.ld_e;
    const float* task = task_s + (size_t)r * p.ld_e;
    const float* W = vw_s + (size_t)r * p.ld_vw;
    float part = 0.f;
    for (int f = lane; f < E2; f += 32) {
      float m = vb_s[(size_t)r * p.ld_vb + f];
      for (int e = 0; e < E; ++e) m = fmaf(x[e], W[e * E2 + f], m);
      for (int e = 0; e < E; ++e) m = fmaf(task[e], W[(E + e) * E2 + f], m);
      part = fmaf(fused::lrelu(m), __ldg(p.v + f), part);
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) score_s[(size_t)r * p.ld_n + n] = part;
  }
  __syncthreads();
  fused::softmax_rows(score_s, p.ld_n, nE, rows);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, f = i % E;
    const float* a = score_s + (size_t)r * p.ld_n;
    float s = a[0] * ex_s[(size_t)r * p.ld_e + f];
    for (int n = 1; n < nE; ++n) s = fmaf(a[n], ex_s[((size_t)n * tb + r) * p.ld_e + f], s);
    rt_s[(size_t)r * p.ld_e + f] = s;
  }
  __syncthreads();
  // meta-tower: the row's own [E, E] matrix, its bias and the residual
  for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
    const int r = i / E, f = i % E;
    const float* rt = rt_s + (size_t)r * p.ld_e;
    const float* T = tw_s + (size_t)r * p.ld_tw;
    float h = tbias_s[(size_t)r * p.ld_e + f] + rt[f];
    for (int e = 0; e < E; ++e) h = fmaf(rt[e], T[e * E + f], h);
    h_s[(size_t)r * p.ld_e + f] = fused::lrelu(h);
  }
  __syncthreads();
  const Act o = fused::chain<SR, 1>(all, Act{h_s, 0, p.ld_e}, first[kOut], p.cnt[kOut], 0, 0,
                                    pp0, pp1, p.ld_w, rows);
  fused::chain<SR, 0>(all, o, first[kChains], 1, 0, 0, pp0, pp1, p.ld_w, rows, logit, 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

}  // namespace

extern "C" {

// counts: the stages of the expert, task, scenario, vw, vb, tw, tb and
// output chains (8 ints); the head follows them. w_ptrs/b_ptrs: host arrays
// of device pointers, one per stage, in that order (the expert stages
// stacked [nE, in, out]); dims: (K, N) per stage. Writes the dynamic shared
// memory a block needs to *smem_bytes. Returns a cudaError_t.
int m2m_fused_infer_f32(const void* t_out, const void* dom_emb, void* out, int B, int F,
                        int Fd, int nE, int E, const void* counts, const void* v,
                        const void* w_ptrs, const void* b_ptrs, const void* dims,
                        int block_rows, void* stream, size_t* smem_bytes) {
  Args p = {};
  const int* c = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || Fd < 1 || nE < 1 || E < 1 || block_rows < fused::kSharedRows ||
      block_rows > fused::kMaxBlockRows || block_rows % fused::kSharedRows != 0)
    return (int)cudaErrorInvalidValue;
  int n = 1;
  for (int i = 0; i < kChains; ++i) {
    p.cnt[i] = c[i];
    if (c[i] < (i == kOut ? 0 : 1) || c[i] > kMaxChain) return (int)cudaErrorInvalidValue;
    n += c[i];
  }
  if (!fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims)) return (int)cudaErrorInvalidValue;
  // each chain runs from its input width to the width the next step needs;
  // every stage but a chain's last goes through the ping-pong buffers, and
  // the output chain's last too (the head reads it there)
  const int start[kChains] = {F, Fd, Fd, E, E, E, E, E};
  const int end[kChains] = {E, E, E, 4 * E * E, 2 * E, E * E, E, -1};
  const Stage* st = p.st;
  int ld_w = 1, width = E;
  for (int i = 0; i < kChains; ++i) {
    width = start[i];
    for (int s = 0; s < c[i]; ++s, ++st) {
      if (st->K != width) return (int)cudaErrorInvalidValue;
      width = st->N;
      if (s < c[i] - 1 || i == kOut) ld_w = width > ld_w ? width : ld_w;
    }
    if (end[i] >= 0 && width != end[i]) return (int)cudaErrorInvalidValue;
  }
  if (st->K != width || st->N != 1) return (int)cudaErrorInvalidValue;  // the head
  p.t_out = static_cast<const float*>(t_out);
  p.dom = static_cast<const float*>(dom_emb);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.Fd = Fd; p.nE = nE; p.E = E; p.tb = block_rows;
  p.ld_f = fused::round4(F);
  p.ld_d = fused::round4(Fd);
  p.ld_e = fused::round4(E);
  p.ld_vw = fused::round4(4 * E * E);
  p.ld_vb = fused::round4(2 * E);
  p.ld_tw = fused::round4(E * E);
  p.ld_w = fused::round4(ld_w);
  p.ld_n = fused::round4(nE);
  const size_t tb = block_rows;
  const size_t floats =
      tb * (p.ld_f + p.ld_d + (size_t)(5 + nE) * p.ld_e + p.ld_vw + p.ld_vb + p.ld_tw +
            2 * (size_t)p.ld_w + p.ld_n) +
      fused::round4(block_rows);
  const size_t smem = floats * sizeof(float) + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(m2m_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
