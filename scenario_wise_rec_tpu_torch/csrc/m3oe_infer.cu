// Fused M3oE eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/m3oe_infer.py:
// m3oe_fused_infer. Per row, d = clip(domain_id, 0, D-1):
//   skip  = Mlp_N(emb)                       (Linear -> LayerNorm -> relu),
//   star  = emb W_star[d] + b_star[d]        (slot_w[d] ⊙ shared_w),
//   e     = Mlp_N(star) + skip,
//   fea_i = Mlp_N_i(e) for the E shared experts,
//   dom_k = Mlp_N_k(e) for EVERY domain k (the balance mix sums them all),
//   g     = softmax(e W_gate[d] + b_gate[d]),
//   fused = sum_i g_i fea_i + w_exp ((w_bal - off) dom_d + off sum_k dom_k),
//           off = (1 - w_bal) / (D - 1)  (w_exp w_bal dom_d when D == 1),
//   prob  = sigmoid(Linear(relu(LayerNorm(Linear(fused))))) of domain d.
// The TPU kernel computes every domain's slot, gate and tower and selects;
// here a row computes only its own domain's (the value is the same).
//
// A LayerNorm is a reduction across a row's own output columns in the
// middle of the stack: a dense stage writes its outputs to shared memory,
// then one warp per row takes the mean and the biased variance (eps 1e-5)
// by warp sums and rewrites the row normalised, scaled and relu'd.
//
// What bounds it on this card: arithmetic. At M3oE's Ali-CCP shape (s0 =
// 376, star [512, 256], experts [256 -> 64] x 4, domain experts x 3, 3
// domains) a row costs ~540k multiply-adds against ~1.5 KB of its own data
// moved; a 4096-row batch is ~4.4 GFLOP against ~10 MB (the weights 3.7 MB
// once): the FP32 SIMT peak bounds it.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 8); the tile and every activation live in dynamic
// shared memory, the weights stream from L2. The skip, the star MLP, the
// experts and the domain experts are shared-weight stages (8 rows a
// group); the star slot, the gate and the tower are per-domain stages on
// the rows grouped by domain (4 a group). Shared memory bounds tb: 24 rows
// at Ali-CCP widths.
//
// The weights come as one list of stages, each (w, b, gamma, beta), gamma
// and beta null where no LayerNorm follows: the star slot, the skip layers,
// the star MLP layers, the expert layers, the domain expert layers, the
// gate, the tower's first Linear with its LayerNorm, the tower's head.
// w_exp and w_bal are one float each on the device.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;

constexpr int kMaxLayers = 8;  // Mlp_N layers of one chain
constexpr int kMaxStages = 4 * kMaxLayers + 4;
constexpr float kEps = 1e-5f;
enum { kSkip, kStarMlp, kExperts, kDomExperts, kChains };

// A dense stage W [members..., K, N], b [members..., N] and, when a
// LayerNorm follows, its gamma and beta [members..., N].
struct LnStage {
  const float* w;
  const float* b;
  const float* g;
  const float* be;
  int K, N;
};

struct Args {
  const float* emb;    // [B, F]
  const int* did;      // [B]
  const float* w_exp;  // [1]
  const float* w_bal;  // [1]
  float* out;          // [B]
  int B, F, D, E, tb;
  int cnt[kChains];
  int ld_f, ld_1, ld_2, ld_w, ld_h, ld_g, ld_t;
  LnStage st[kMaxStages];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// relu(LayerNorm(x)) in place for rows [0, rows) of x [., ld], N columns,
// one warp a row: gamma/beta at g/be, plus did_s[r] * dstride when dstride
// is not 0 (a per-domain norm). Every thread of the block calls it.
__device__ void ln_relu_rows(float* x, int ld, int N, int rows, const float* __restrict__ g,
                             const float* __restrict__ be, size_t dstride, const int* did_s) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* v = x + (size_t)r * ld;
    const size_t o = dstride ? (size_t)did_s[r] * dstride : 0;
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s += v[j];
    const float mean = warp_sum(s) / N;
    float q = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float c = v[j] - mean;
      q = fmaf(c, c, q);
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / N + kEps);
    for (int j = lane; j < N; j += 32)
      v[j] = fused::relu((v[j] - mean) * rstd * __ldg(g + o + j) + __ldg(be + o + j));
  }
}

// Runs Mlp_N layers st[0..n) on `in`: each a dense stage, then the
// LayerNorm and relu. Layer s of group g uses member `member + dom[g] *
// dmul`, as fused::chain; intermediate results alternate between pp0 and
// pp1, the last layer writes to `last`. Ends synchronised.
template <int R>
__device__ void ln_chain(const Groups& G, Act in, const LnStage* st, int n, int member,
                         int dmul, const int* did_s, float* pp0, float* pp1, int ld_pp,
                         int rows, float* last, int ld_last) {
  for (int s = 0; s < n; ++s) {
    const LnStage& S = st[s];
    const size_t kn = (size_t)S.K * S.N;
    float* out = s == n - 1 ? last : (in.p == pp0 ? pp1 : pp0);
    const int ld_out = s == n - 1 ? ld_last : ld_pp;
    fused::dense<R, false>(G, in, S.K, S.w + (size_t)member * kn, (size_t)dmul * kn,
                           S.b + (size_t)member * S.N, (size_t)dmul * S.N, S.N, out, ld_out);
    __syncthreads();
    ln_relu_rows(out, ld_out, S.N, rows, S.g + (size_t)member * S.N,
                 S.be + (size_t)member * S.N, (size_t)dmul * S.N, did_s);
    __syncthreads();
    in = Act{out, 0, ld_out};
  }
}

__global__ void __launch_bounds__(fused::kThreads)
m3oe_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int SR = fused::kSharedRows, DR = fused::kDomainRows;
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, D = p.D, E = p.E;
  float* emb_s = smem;                                 // [tb, ld_f]
  float* skip_s = emb_s + (size_t)tb * p.ld_f;         // [tb, ld_2]
  float* star_s = skip_s + (size_t)tb * p.ld_2;        // [tb, ld_1]
  float* e_s = star_s + (size_t)tb * p.ld_1;           // [tb, ld_2]
  float* pp0 = e_s + (size_t)tb * p.ld_2;              // [tb, ld_w]
  float* pp1 = pp0 + (size_t)tb * p.ld_w;              // [tb, ld_w]
  float* fea_s = pp1 + (size_t)tb * p.ld_w;            // [E, tb, ld_h]
  float* dom_s = fea_s + (size_t)E * tb * p.ld_h;      // [D, tb, ld_h]
  float* gate_s = dom_s + (size_t)D * tb * p.ld_h;     // [tb, ld_g]
  float* fused_s = gate_s + (size_t)tb * p.ld_g;       // [tb, ld_h]
  float* th_s = fused_s + (size_t)tb * p.ld_h;         // [tb, ld_t]
  float* logit = th_s + (size_t)tb * p.ld_t;           // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.did, row0, rows, p.F, D, emb_s, p.ld_f, tb, did_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  const LnStage* star = p.st;
  const LnStage* first[kChains + 1];  // each chain's first layer; the gate last
  first[0] = star + 1;
  for (int c = 0; c < kChains; ++c) first[c + 1] = first[c] + p.cnt[c];
  const LnStage* gate = first[kChains];
  const LnStage* tower = gate + 1;  // l1 with its norm, then the head
  const int s1 = star->N, s2 = gate->K, H = tower->K;

  const Act emb{emb_s, 0, p.ld_f};
  ln_chain<SR>(all, emb, first[kSkip], p.cnt[kSkip], 0, 0, did_s, pp0, pp1, p.ld_w, rows,
               skip_s, p.ld_2);
  // the row's own domain's slot, no activation
  fused::dense<DR, false>(own, emb, p.F, star->w, (size_t)p.F * s1, star->b, s1, s1, star_s,
                          p.ld_1);
  __syncthreads();
  ln_chain<SR>(all, Act{star_s, 0, p.ld_1}, first[kStarMlp], p.cnt[kStarMlp], 0, 0, did_s,
               pp0, pp1, p.ld_w, rows, e_s, p.ld_2);
  for (int i = threadIdx.x; i < rows * s2; i += blockDim.x) {
    const int r = i / s2, j = i % s2;
    e_s[(size_t)r * p.ld_2 + j] += skip_s[(size_t)r * p.ld_2 + j];
  }
  __syncthreads();
  const Act e{e_s, 0, p.ld_2};
  for (int i = 0; i < E; ++i)
    ln_chain<SR>(all, e, first[kExperts], p.cnt[kExperts], i, 0, did_s, pp0, pp1, p.ld_w,
                 rows, fea_s + (size_t)i * tb * p.ld_h, p.ld_h);
  for (int k = 0; k < D; ++k)  // every domain's expert, for the balance mix
    ln_chain<SR>(all, e, first[kDomExperts], p.cnt[kDomExperts], k, 0, did_s, pp0, pp1,
                 p.ld_w, rows, dom_s + (size_t)k * tb * p.ld_h, p.ld_h);
  fused::dense<DR, false>(own, e, s2, gate->w, (size_t)s2 * E, gate->b, E, E, gate_s, p.ld_g);
  __syncthreads();
  fused::softmax_rows(gate_s, p.ld_g, E, rows);
  __syncthreads();

  // the gate mixture, the balance mix and the fusion
  const float w_exp = __ldg(p.w_exp), w_bal = __ldg(p.w_bal);
  const float off = D > 1 ? (1.f - w_bal) / (float)(D - 1) : 0.f;
  const float own_w = D > 1 ? w_bal - off : w_bal;
  const size_t slot = (size_t)tb * p.ld_h;
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int r = i / H, j = i % H;
    const float* g = gate_s + (size_t)r * p.ld_g;
    const float* f = fea_s + (size_t)r * p.ld_h + j;
    const float* dm = dom_s + (size_t)r * p.ld_h + j;
    float mixed = g[0] * f[0];
    for (int q = 1; q < E; ++q) mixed = fmaf(g[q], f[q * slot], mixed);
    float total = dm[0];
    for (int k = 1; k < D; ++k) total += dm[k * slot];
    const float bal = own_w * dm[did_s[r] * slot] + off * total;
    fused_s[(size_t)r * p.ld_h + j] = mixed + w_exp * bal;
  }
  __syncthreads();
  // the own domain's tower: Linear, LayerNorm, relu, then the head
  ln_chain<DR>(own, Act{fused_s, 0, p.ld_h}, tower, 1, 0, 1, did_s, pp0, pp1, p.ld_w, rows,
               th_s, p.ld_t);
  const LnStage* head = tower + 1;
  fused::dense<DR, false>(own, Act{th_s, 0, p.ld_t}, head->K, head->w, (size_t)head->K,
                          head->b, 1, 1, logit, 1);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

}  // namespace

extern "C" {

// counts: the layers of the skip, star MLP, expert and domain expert chains
// (4 ints). w_ptrs/b_ptrs/g_ptrs/be_ptrs: host arrays of device pointers,
// one per stage in the order of the file's header (g/be null where no
// LayerNorm follows); dims: (K, N) per stage. w_exp/w_bal: device pointers
// to one float each. Writes the dynamic shared memory a block needs to
// *smem_bytes. Returns a cudaError_t.
int m3oe_fused_infer_f32(const void* emb, const void* did, void* out, int B, int F, int D,
                         int E, const void* counts, const void* w_ptrs, const void* b_ptrs,
                         const void* g_ptrs, const void* be_ptrs, const void* dims,
                         const void* w_exp, const void* w_bal, int block_rows, void* stream,
                         size_t* smem_bytes) {
  Args p = {};
  const int* c = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || D < 1 || E < 1 || block_rows < fused::kSharedRows ||
      block_rows > fused::kMaxBlockRows || block_rows % fused::kSharedRows != 0)
    return (int)cudaErrorInvalidValue;
  int n = 4;  // the star, the gate, the tower's two stages
  for (int i = 0; i < kChains; ++i) {
    if (c[i] < 1 || c[i] > kMaxLayers) return (int)cudaErrorInvalidValue;
    p.cnt[i] = c[i];
    n += c[i];
  }
  const float* const* w = static_cast<const float* const*>(w_ptrs);
  const float* const* b = static_cast<const float* const*>(b_ptrs);
  const float* const* g = static_cast<const float* const*>(g_ptrs);
  const float* const* be = static_cast<const float* const*>(be_ptrs);
  const int* kn = static_cast<const int*>(dims);
  for (int s = 0; s < n; ++s) {
    const bool norm = s > 0 && s != n - 3 && s != n - 1;  // not star, gate or head
    if (kn[2 * s] < 1 || kn[2 * s + 1] < 1 || w[s] == nullptr || b[s] == nullptr ||
        norm != (g[s] != nullptr) || norm != (be[s] != nullptr))
      return (int)cudaErrorInvalidValue;
    p.st[s] = LnStage{w[s], b[s], g[s], be[s], kn[2 * s], kn[2 * s + 1]};
  }
  // widths: star F -> s1; skip F -> s2; star MLP s1 -> s2; both expert
  // chains s2 -> H; gate s2 -> E; tower H -> T -> 1. Every layer but a
  // chain's last goes through the ping-pong buffers.
  const LnStage* st = p.st;
  const int s1 = st[0].N;
  if (st[0].K != F) return (int)cudaErrorInvalidValue;
  const int start[kChains] = {F, s1, -1, -1};
  int ends[kChains] = {0, 0, 0, 0}, ld_w = 1;
  const LnStage* cur = st + 1;
  for (int i = 0; i < kChains; ++i) {
    int width = start[i] >= 0 ? start[i] : ends[kSkip];
    for (int s = 0; s < c[i]; ++s, ++cur) {
      if (cur->K != width) return (int)cudaErrorInvalidValue;
      width = cur->N;
      if (s < c[i] - 1) ld_w = width > ld_w ? width : ld_w;
    }
    ends[i] = width;
  }
  const int s2 = ends[kSkip], H = ends[kExperts];
  const LnStage &gate = cur[0], &l1 = cur[1], &head = cur[2];
  if (ends[kStarMlp] != s2 || ends[kDomExperts] != H || gate.K != s2 || gate.N != E ||
      l1.K != H || head.K != l1.N || head.N != 1)
    return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.w_exp = static_cast<const float*>(w_exp);
  p.w_bal = static_cast<const float*>(w_bal);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.D = D; p.E = E; p.tb = block_rows;
  p.ld_f = fused::round4(F);
  p.ld_1 = fused::round4(s1);
  p.ld_2 = fused::round4(s2);
  p.ld_w = fused::round4(ld_w);
  p.ld_h = fused::round4(H);
  p.ld_g = fused::round4(E);
  p.ld_t = fused::round4(l1.N);
  const size_t tb = block_rows;
  const size_t floats = tb * (p.ld_f + 2 * (size_t)p.ld_2 + p.ld_1 + 2 * (size_t)p.ld_w +
                              (size_t)(E + D + 1) * p.ld_h + p.ld_g + p.ld_t) +
                        fused::round4(block_rows);
  const size_t smem = floats * sizeof(float) + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(m3oe_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
