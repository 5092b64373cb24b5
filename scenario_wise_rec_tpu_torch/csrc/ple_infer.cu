// Fused PLE (CGC) eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/ple_infer.py:
// ple_fused_infer. Each level reads D + 1 streams per row (one per domain,
// one shared; all the embedding at level 1). Per level:
//   spec[d][s] = relu MLP of domain d's specific expert s on stream d,
//   shared[j]  = relu MLP of shared expert j on the shared stream,
//   gate[d]    = domain d's gate on stream d, a softmax after every stage,
//   stream d  <- sum_e gate[d][e] * (spec[d][0..S), shared[0..n_sh))[e],
// and a level before the last also has a shared gate on the shared stream
// over all D*S + n_sh experts, which makes the next shared stream. After
// the last level, the row's own domain d = clip(domain_id, 0, D-1) runs its
// relu tower and 1-unit head, then the sigmoid.
//
// Which rows need what: at the last level a row needs only its own domain's
// stream, so only its own S specifics, the shared experts and its own gate
// (at Ali-CCP width, 3 expert MLPs per row, as MMOE). A level before the
// last feeds every domain's stream and the shared gate mixes every expert,
// so there every domain's experts and gates run for every row. The TPU
// kernel computes all of them at every level and selects at the end; the
// value per row is the same.
//
// What bounds it on this card: arithmetic. At PLE's Ali-CCP shape (F = 376,
// 1 level, 2 specific + 1 shared experts [256,128,64,32,16,8], tower [16],
// 3 domains) a row costs ~421k multiply-adds and moves ~1.5 KB, so a 4096-
// row batch is ~3.45 GFLOP against ~8 MB: the FP32 SIMT peak bounds it.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16). Its tile, two ping-pong buffers, the D + 1
// streams, every expert output of a level and every gate live in dynamic
// shared memory; weights stream from L2. Shared-weight stages run on the
// tile's rows 8 at a time; per-domain ones on rows grouped by domain, 4 at a
// time.
//
// The weights come as one list in a fixed order, as the TPU kernel's cursor
// takes them: for each level its specific, shared, gate and shared-gate
// stages, then the tower stages, then the head.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

constexpr int kMaxLevels = 4;

struct Args {
  const float* emb;  // [B, F]
  const int* did;    // [B]
  float* out;        // [B]
  int B, F, D, S, n_sh, n_level, n_tow, tb;
  int ld_f, ld_w, ld_s, ld_h, ld_g, n_slots, n_gates;
  int cnt[kMaxLevels][4];  // per level: spec, shared, gate, shared-gate stages
  Stage st[fused::kMaxStages];
};

// slot of the e-th expert of domain d's gate: its own specifics, then shared
__device__ __forceinline__ int own_slot(int d, int e, int D, int S) {
  return e < S ? d * S + e : D * S + (e - S);
}

__global__ void __launch_bounds__(fused::kThreads)
ple_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, D = p.D, S = p.S, n_sh = p.n_sh;
  float* emb_s = smem;                                  // [tb, ld_f]
  float* pp0 = emb_s + (size_t)tb * p.ld_f;             // [tb, ld_w]
  float* pp1 = pp0 + (size_t)tb * p.ld_w;               // [tb, ld_w]
  float* streams = pp1 + (size_t)tb * p.ld_w;           // [D + 1, tb, ld_s]
  float* slots = streams + (size_t)(p.n_level > 1 ? D + 1 : 0) * tb * p.ld_s;
  float* gates = slots + (size_t)p.n_slots * tb * p.ld_h;  // [n_gates, tb, ld_g]
  float* logit = gates + (size_t)p.n_gates * tb * p.ld_g;  // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.did, row0, rows, p.F, D, emb_s, p.ld_f, tb, did_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  const size_t slot_stride = (size_t)tb * p.ld_h, gate_stride = (size_t)tb * p.ld_g;
  const Stage* cur = p.st;
  for (int l = 0; l < p.n_level; ++l) {
    const Stage* spec = cur;
    const Stage* shared = spec + p.cnt[l][0];
    const Stage* gate = shared + p.cnt[l][1];
    const Stage* gate_sh = gate + p.cnt[l][2];
    cur = gate_sh + p.cnt[l][3];
    const int H = spec[p.cnt[l][0] - 1].N;
    // stream d of domain d, and the shared stream
    const Act in_d = l == 0 ? Act{emb_s, 0, p.ld_f}
                            : Act{streams, (size_t)tb * p.ld_s, p.ld_s};
    const Act in_sh = l == 0 ? Act{emb_s, 0, p.ld_f}
                             : Act{streams + (size_t)D * tb * p.ld_s, 0, p.ld_s};
    if (l < p.n_level - 1) {
      // every domain's experts and gate, for every row
      for (int d = 0; d < D; ++d) {
        const Act x{in_d.p + d * in_d.dstride, 0, in_d.ld};
        for (int s = 0; s < S; ++s)
          fused::chain<fused::kSharedRows, 1>(all, x, spec, p.cnt[l][0], d * S + s, 0,
                                              pp0, pp1, p.ld_w, rows,
                                              slots + (d * S + s) * slot_stride, p.ld_h);
        fused::chain<fused::kSharedRows, 2>(all, x, gate, p.cnt[l][2], d, 0, pp0, pp1,
                                            p.ld_w, rows, gates + d * gate_stride, p.ld_g);
      }
      for (int j = 0; j < n_sh; ++j)
        fused::chain<fused::kSharedRows, 1>(all, in_sh, shared, p.cnt[l][1], j, 0, pp0,
                                            pp1, p.ld_w, rows,
                                            slots + (D * S + j) * slot_stride, p.ld_h);
      fused::chain<fused::kSharedRows, 2>(all, in_sh, gate_sh, p.cnt[l][3], 0, 0, pp0,
                                          pp1, p.ld_w, rows, gates + D * gate_stride,
                                          p.ld_g);
      // the next D + 1 streams: each domain's gate over its own experts, the
      // shared gate over all D*S + n_sh
      const int E = S + n_sh, n_all = D * S + n_sh;
      for (int i = threadIdx.x; i < (D + 1) * rows * H; i += blockDim.x) {
        const int h = i % H, r = (i / H) % rows, d = i / (H * rows);
        const float* g = gates + d * gate_stride + (size_t)r * p.ld_g;
        const float* x = slots + (size_t)r * p.ld_h + h;
        float m;
        if (d < D) {
          m = g[0] * x[own_slot(d, 0, D, S) * slot_stride];
          for (int e = 1; e < E; ++e)
            m = fmaf(g[e], x[own_slot(d, e, D, S) * slot_stride], m);
        } else {
          m = g[0] * x[0];
          for (int e = 1; e < n_all; ++e) m = fmaf(g[e], x[e * slot_stride], m);
        }
        streams[(d * tb + r) * (size_t)p.ld_s + h] = m;
      }
      __syncthreads();
    } else {
      // the last level: the row's own domain only
      for (int s = 0; s < S; ++s)
        fused::chain<fused::kDomainRows, 1>(own, in_d, spec, p.cnt[l][0], s, S, pp0, pp1,
                                            p.ld_w, rows, slots + s * slot_stride, p.ld_h);
      for (int j = 0; j < n_sh; ++j)
        fused::chain<fused::kSharedRows, 1>(all, in_sh, shared, p.cnt[l][1], j, 0, pp0,
                                            pp1, p.ld_w, rows, slots + (S + j) * slot_stride,
                                            p.ld_h);
      fused::chain<fused::kDomainRows, 2>(own, in_d, gate, p.cnt[l][2], 0, 1, pp0, pp1,
                                          p.ld_w, rows, gates, p.ld_g);
      const int E = S + n_sh;
      for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
        const int h = i % H, r = i / H;
        const float* g = gates + (size_t)r * p.ld_g;
        const float* x = slots + (size_t)r * p.ld_h + h;
        float m = g[0] * x[0];
        for (int e = 1; e < E; ++e) m = fmaf(g[e], x[e * slot_stride], m);
        pp0[(size_t)r * p.ld_w + h] = m;
      }
      __syncthreads();
    }
  }
  // the own domain's tower and head on the mixed stream in pp0
  Act t = fused::chain<fused::kDomainRows, 1>(own, Act{pp0, 0, p.ld_w}, cur, p.n_tow, 0, 1,
                                              pp0, pp1, p.ld_w, rows);
  fused::chain<fused::kDomainRows, 0>(own, t, cur + p.n_tow, 1, 0, 1, pp0, pp1, p.ld_w,
                                      rows, logit, 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

}  // namespace

extern "C" {

// counts: per level 4 ints (specific, shared, gate, shared-gate stages; the
// last level's shared-gate count is 0). w_ptrs/b_ptrs: host arrays of
// device pointers, one per stage, in the order of the file's header; dims:
// (K, N) per stage. Writes the dynamic shared memory a block needs to
// *smem_bytes. Returns a cudaError_t.
int ple_fused_infer_f32(const void* emb, const void* did, void* out, int B, int F, int D,
                        int S, int n_sh, int n_level, const void* counts, int n_tow,
                        const void* w_ptrs, const void* b_ptrs, const void* dims,
                        int block_rows, void* stream, size_t* smem_bytes) {
  Args p = {};
  const int* c = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || D < 1 || S < 1 || n_sh < 1 || n_level < 1 ||
      n_level > kMaxLevels || n_tow < 0 || block_rows < fused::kSharedRows ||
      block_rows > fused::kMaxBlockRows || block_rows % fused::kSharedRows != 0)
    return (int)cudaErrorInvalidValue;
  int n = n_tow + 1;
  for (int l = 0; l < n_level; ++l)
    for (int i = 0; i < 4; ++i) {
      p.cnt[l][i] = c[4 * l + i];
      n += c[4 * l + i];
    }
  if (!fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims)) return (int)cudaErrorInvalidValue;
  // widths: each chain starts at its level's stream width and ends where the
  // mixture needs it
  const int E = S + n_sh, n_all = D * S + n_sh;
  int width = F, ld_w = 1, ld_s = 1, ld_h = 1, ld_g = 1, n_slots = E;
  const Stage* st = p.st;
  for (int l = 0; l < n_level; ++l) {
    const bool last = l == n_level - 1;
    const int* k = p.cnt[l];
    if (k[0] < 1 || k[1] < 1 || k[2] < 1 || (last ? k[3] != 0 : k[3] < 1))
      return (int)cudaErrorInvalidValue;
    const int H = st[k[0] - 1].N;
    const int ends[4] = {H, H, E, n_all};
    for (int i = 0; i < 4; ++i) {
      int w = width;
      for (int s = 0; s < k[i]; ++s, ++st) {
        if (st->K != w) return (int)cudaErrorInvalidValue;
        w = st->N;
        ld_w = w > ld_w ? w : ld_w;
      }
      if (k[i] && w != ends[i]) return (int)cudaErrorInvalidValue;
    }
    ld_h = H > ld_h ? H : ld_h;
    ld_g = (last ? E : n_all) > ld_g ? (last ? E : n_all) : ld_g;
    if (!last) {
      ld_s = H > ld_s ? H : ld_s;
      n_slots = n_all > n_slots ? n_all : n_slots;
    }
    width = H;
  }
  for (int s = 0; s <= n_tow; ++s, ++st) {
    if (st->K != width) return (int)cudaErrorInvalidValue;
    width = st->N;
    ld_w = width > ld_w ? width : ld_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.D = D; p.S = S; p.n_sh = n_sh; p.n_level = n_level;
  p.n_tow = n_tow; p.tb = block_rows;
  p.ld_f = fused::round4(F);
  p.ld_w = fused::round4(ld_w);
  p.ld_s = fused::round4(ld_s);
  p.ld_h = fused::round4(ld_h);
  p.ld_g = fused::round4(ld_g);
  p.n_slots = n_slots;
  p.n_gates = n_level > 1 ? D + 1 : 1;
  const size_t tb = block_rows;
  const size_t floats = tb * p.ld_f + 2 * tb * p.ld_w
                        + (n_level > 1 ? (size_t)(D + 1) * tb * p.ld_s : 0)
                        + (size_t)n_slots * tb * p.ld_h + (size_t)p.n_gates * tb * p.ld_g
                        + fused::round4(block_rows);
  const size_t smem = floats * sizeof(float) + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(ple_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
