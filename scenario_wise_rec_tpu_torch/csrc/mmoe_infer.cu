// Fused MMOE eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/mmoe_infer.py:
// mmoe_fused_infer. For each row b of the embedded batch emb[B, F] it
// computes E relu expert MLPs, the softmax gate over E of the row's own
// domain d = clip(domain_id[b], 0, D-1), the gate-weighted mixture of the
// expert outputs, domain d's relu tower, its 1-unit head and the sigmoid.
// That is the TPU kernel's function: it computes every domain and selects
// with jnp.where, which gives the same value per row.
//
// What bounds it on this card: arithmetic. At the Ali-CCP shape (F = 376,
// 3 experts of [256,128,64,32,16,8], 3 domains, tower [16]) a row costs
// ~0.42 M f32 multiply-adds and moves ~1.5 KB, so a 4096-row batch is
// ~3.5 GFLOP against ~8 MB: f32 without tensor cores, the FP32 SIMT peak
// (67 TFLOP/s on an H100 SXM at 700 W) bounds it, not HBM.
//
// What the design does about it: everything after the embedding stays on
// chip. One block of 256 threads owns TB rows (default 16); it stages its
// emb tile and two ping-pong activation buffers in dynamic shared memory,
// and keeps the E expert outputs there too, so the only device-memory
// traffic is one read of the tile, the weights (1.7 MB, L2-resident) and
// one write of the probabilities. In each dense layer a thread holds 8 rows
// of one output column in registers: one weight load feeds 8 FMAs, and the
// activations are read from shared memory as float4 along k, broadcast to
// the warp. Blocks are independent; the ragged last tile is masked here
// (no pad copy). Simple first: no tensor cores (wgmma) and no TMA yet.
//
// Bound through ctypes: a plain C interface, every pointer and the stream
// as void*, the cudaError_t of the launch returned.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxStages = 8;       // expert and tower depth limit
constexpr int kMaxExperts = 16;     // gate registers per row
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;   // rows of one column a thread accumulates

struct Args {
  const float* emb;   // [B, F]
  const int* did;     // [B]
  float* out;         // [B]
  int B, F, E, D, n_exp, n_tow, tb;
  int ld_f, ld_w, ld_h;  // shared-memory row strides (floats, multiples of 4)
  const float* ew[kMaxStages];  // expert stage s: W [E, in, out]
  const float* eb[kMaxStages];  //                 b [E, out]
  int edim[kMaxStages + 1];     // F, widths...
  const float* gw;              // [D, F, E]
  const float* gb;              // [D, E]
  const float* tw[kMaxStages];  // tower stage s: W [D, in, out]
  const float* tbias[kMaxStages];  //             b [D, out]
  int tdim[kMaxStages + 1];     // H, widths...
  const float* ow;              // head W [D, h, 1]
  const float* ob;              // head b [D, 1]
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// relu that keeps a NaN visible, as max(x, 0) does in XLA
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r, j] = relu(sum_k in[r, k] * W[k, j] + b[j]) for the tile's tb rows.
// in/out live in shared memory; W [K, N] and b [N] in device memory.
__device__ void dense_relu_tile(const float* in, int ld_in, int K,
                                const float* __restrict__ W,
                                const float* __restrict__ bias, int N,
                                float* out, int ld_out, int tb) {
  const int items = (tb / kRowsPerThread) * N;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int j = item % N;
    const int r0 = (item / N) * kRowsPerThread;
    const float* a = in + r0 * ld_in;
    float acc[kRowsPerThread];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = __ldg(W + (size_t)(k + 0) * N + j);
      const float w1 = __ldg(W + (size_t)(k + 1) * N + j);
      const float w2 = __ldg(W + (size_t)(k + 2) * N + j);
      const float w3 = __ldg(W + (size_t)(k + 3) * N + j);
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(a + m * ld_in + k);
        acc[m] = fmaf(v.x, w0, acc[m]);
        acc[m] = fmaf(v.y, w1, acc[m]);
        acc[m] = fmaf(v.z, w2, acc[m]);
        acc[m] = fmaf(v.w, w3, acc[m]);
      }
    }
    for (; k < K; ++k) {
      const float wk = __ldg(W + (size_t)k * N + j);
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m)
        acc[m] = fmaf(a[m * ld_in + k], wk, acc[m]);
    }
    const float bj = __ldg(bias + j);
    float* o = out + r0 * ld_out + j;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) o[m * ld_out] = relu(acc[m] + bj);
  }
}

__global__ void __launch_bounds__(kThreads)
mmoe_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb;
  float* emb_s = smem;                        // [tb, ld_f]
  float* buf0 = emb_s + tb * p.ld_f;          // [tb, ld_w]
  float* buf1 = buf0 + tb * p.ld_w;           // [tb, ld_w]
  float* xout = buf1 + tb * p.ld_w;           // [E, tb, ld_h]
  float* gate_s = xout + p.E * tb * p.ld_h;   // [tb, E]
  int* did_s = reinterpret_cast<int*>(gate_s + tb * p.E);  // [tb]

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;

  // 1. stage the emb tile; rows past the batch and pad columns are zero
  for (int i = threadIdx.x; i < tb * p.ld_f; i += blockDim.x) {
    const int r = i / p.ld_f, c = i % p.ld_f;
    emb_s[i] = (r < rows && c < p.F) ? p.emb[(size_t)(row0 + r) * p.F + c]
                                     : 0.f;
  }
  for (int r = threadIdx.x; r < tb; r += blockDim.x) {
    const int d = r < rows ? p.did[row0 + r] : 0;
    did_s[r] = min(max(d, 0), p.D - 1);
  }
  __syncthreads();

  // 2. gate of the row's own domain: softmax over E (max subtracted)
  for (int r = warp; r < tb; r += nwarps) {
    const int d = did_s[r];
    const float* wg = p.gw + (size_t)d * p.F * p.E;
    const float* a = emb_s + r * p.ld_f;
    float acc[kMaxExperts];
#pragma unroll
    for (int e = 0; e < kMaxExperts; ++e) acc[e] = 0.f;
    for (int k = lane; k < p.F; k += 32) {
      const float x = a[k];
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e)
        if (e < p.E) acc[e] = fmaf(x, __ldg(wg + (size_t)k * p.E + e), acc[e]);
    }
#pragma unroll
    for (int e = 0; e < kMaxExperts; ++e)
      if (e < p.E) acc[e] = warp_sum(acc[e]);
    if (lane == 0) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e)
        if (e < p.E) {
          acc[e] += __ldg(p.gb + d * p.E + e);
          mx = fmaxf(mx, acc[e]);
        }
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e)
        if (e < p.E) {
          acc[e] = expf(acc[e] - mx);
          s += acc[e];
        }
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e)
        if (e < p.E) gate_s[r * p.E + e] = acc[e] / s;
    }
  }

  // 3. experts: relu MLPs through buf0/buf1, the last stage into xout[e]
  for (int e = 0; e < p.E; ++e) {
    const float* in = emb_s;
    int ld_in = p.ld_f;
    for (int s = 0; s < p.n_exp; ++s) {
      const int K = p.edim[s], N = p.edim[s + 1];
      const bool last = s == p.n_exp - 1;
      float* out = last ? xout + e * tb * p.ld_h : ((s & 1) ? buf1 : buf0);
      const int ld_out = last ? p.ld_h : p.ld_w;
      dense_relu_tile(in, ld_in, K, p.ew[s] + (size_t)e * K * N,
                      p.eb[s] + (size_t)e * N, N, out, ld_out, tb);
      __syncthreads();
      in = out;
      ld_in = ld_out;
    }
  }

  // 4. mixture into buf0: mixed[r, h] = sum_e gate[r, e] * x_e[r, h]
  const int H = p.edim[p.n_exp];
  for (int i = threadIdx.x; i < tb * H; i += blockDim.x) {
    const int r = i / H, h = i % H;
    float m = gate_s[r * p.E] * xout[r * p.ld_h + h];
    for (int e = 1; e < p.E; ++e)
      m += gate_s[r * p.E + e] * xout[(e * tb + r) * p.ld_h + h];
    buf0[r * p.ld_w + h] = m;
  }
  __syncthreads();

  // 5. the row's own tower, head and sigmoid: one warp per row
  for (int r = warp; r < tb; r += nwarps) {
    const int d = did_s[r];
    float* cur = buf0 + r * p.ld_w;
    float* nxt = buf1 + r * p.ld_w;
    for (int s = 0; s < p.n_tow; ++s) {
      const int K = p.tdim[s], N = p.tdim[s + 1];
      const float* w = p.tw[s] + (size_t)d * K * N;
      const float* b = p.tbias[s] + (size_t)d * N;
      for (int j = lane; j < N; j += 32) {
        float acc = 0.f;
        for (int k = 0; k < K; ++k)
          acc = fmaf(cur[k], __ldg(w + (size_t)k * N + j), acc);
        nxt[j] = relu(acc + __ldg(b + j));
      }
      __syncwarp();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    const int K = p.tdim[p.n_tow];
    float part = 0.f;
    for (int k = lane; k < K; k += 32)
      part = fmaf(cur[k], __ldg(p.ow + (size_t)d * K + k), part);
    part = warp_sum(part);
    if (lane == 0 && r < rows) {
      const float logit = part + __ldg(p.ob + d);
      p.out[row0 + r] = 1.f / (1.f + expf(-logit));
    }
  }
}

size_t smem_bytes(int tb, int F, int E, int H, int max_w) {
  const size_t floats = (size_t)tb * round4(F) + 2 * (size_t)tb * round4(max_w)
                        + (size_t)E * tb * round4(H) + (size_t)tb * E;
  return floats * sizeof(float) + (size_t)tb * sizeof(int);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (bytes).
size_t mmoe_fused_infer_smem_bytes(int tb, int F, int E, int n_exp,
                                   const int* exp_dims, int n_tow,
                                   const int* tow_dims) {
  int max_w = 0;
  for (int s = 1; s <= n_exp; ++s) max_w = exp_dims[s] > max_w ? exp_dims[s] : max_w;
  for (int s = 0; s <= n_tow; ++s) max_w = tow_dims[s] > max_w ? tow_dims[s] : max_w;
  return smem_bytes(tb, F, E, exp_dims[n_exp], max_w);
}

// exp_w/exp_b/tow_w/tow_b: host arrays of device pointers, one per stage.
// exp_dims: n_exp + 1 widths starting at F; tow_dims: n_tow + 1 widths
// starting at the expert output width H. Returns a cudaError_t.
int mmoe_fused_infer_f32(const void* emb, const void* did, void* out, int B,
                         int F, int E, int D, int n_exp, const void* exp_w,
                         const void* exp_b, const void* exp_dims,
                         const void* gate_w, const void* gate_b, int n_tow,
                         const void* tow_w, const void* tow_b,
                         const void* tow_dims, const void* head_w,
                         const void* head_b, int block_rows, void* stream) {
  const float* const* ew = static_cast<const float* const*>(exp_w);
  const float* const* eb = static_cast<const float* const*>(exp_b);
  const float* const* tw = static_cast<const float* const*>(tow_w);
  const float* const* tbias = static_cast<const float* const*>(tow_b);
  const int* edim = static_cast<const int*>(exp_dims);
  const int* tdim = static_cast<const int*>(tow_dims);
  if (B < 0 || F < 1 || E < 1 || E > kMaxExperts || D < 1 || n_exp < 1 ||
      n_exp > kMaxStages || n_tow < 0 || n_tow > kMaxStages ||
      block_rows < kRowsPerThread || block_rows % kRowsPerThread != 0 ||
      edim[0] != F || tdim[0] != edim[n_exp])
    return (int)cudaErrorInvalidValue;

  Args p = {};
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.E = E; p.D = D; p.n_exp = n_exp; p.n_tow = n_tow;
  p.tb = block_rows;
  int max_w = 0;
  for (int s = 0; s < n_exp; ++s) {
    p.ew[s] = ew[s];
    p.eb[s] = eb[s];
  }
  for (int s = 0; s <= n_exp; ++s) p.edim[s] = edim[s];
  for (int s = 1; s <= n_exp; ++s) max_w = edim[s] > max_w ? edim[s] : max_w;
  for (int s = 0; s < n_tow; ++s) {
    p.tw[s] = tw[s];
    p.tbias[s] = tbias[s];
  }
  for (int s = 0; s <= n_tow; ++s) {
    p.tdim[s] = tdim[s];
    max_w = tdim[s] > max_w ? tdim[s] : max_w;
  }
  p.gw = static_cast<const float*>(gate_w);
  p.gb = static_cast<const float*>(gate_b);
  p.ow = static_cast<const float*>(head_w);
  p.ob = static_cast<const float*>(head_b);
  p.ld_f = round4(F);
  p.ld_w = round4(max_w);
  p.ld_h = round4(edim[n_exp]);

  const size_t smem = smem_bytes(block_rows, F, E, edim[n_exp], max_w);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mmoe_fused_infer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B == 0) return (int)cudaSuccess;
  const int grid = (B + block_rows - 1) / block_rows;
  mmoe_fused_infer_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
