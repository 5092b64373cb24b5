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
// What bounds it on this card: bytes, once the blocks run on the tensor
// cores. HamurLarge at Ali-CCP (F = 376, blocks [256,128,64,64,32,16 | 8],
// k = 65, 3 domains), B = 4096, its three launches: 151.15 MB, 0.0451 ms at
// 3.35 TB/s, 92 % of it the hyper matrix H (16,900 B a row) that each of
// the two adapter segments reads; the operations take 0.032 ms (the blocks,
// 431,616 multiply-adds a row, as three TF32 products at 495 TFLOP/s, and
// ~0.70 GFLOP of f32 adapters, affines and head at 67). In f32 without
// tensor cores the operations bound it at 0.0632 ms.
//
// What the design does about it (mma_ring.cuh, shared with mmoe_infer.cu):
// - First and middle forms: one block of 8 compute warps and a producer
//   warp owns a tile of 16-64 rows. The blocks run on the tensor cores in
//   3xTF32 (f32's accuracy), the domains in turn as MMOE's experts are: over
//   the shared emb tile (first) or each domain's own input tile (middle),
//   their weights streamed slab by slab through a shared-memory ring by the
//   producer's bulk copies. The last layer's epilogue writes h to out_h.
// - Then the adapter, at H's byte rate: the same shared memory (phase 1's
//   tiles and ring are dead) holds the tile's h rows (read back from out_h,
//   where this block just wrote them), the four shared adapter matrices and
//   two biases, copied once per block by the producer, a scratch per warp,
//   and a ring of H rows. The producer copies each row's H once from device
//   memory into a ring slot (one bulk copy for its 16-byte aligned middle,
//   cp.async for the ragged ends: at k = 65 a row is 16,900 B, so only every
//   4th row starts aligned), as far ahead as slots free up. A compute warp
//   takes a row whole, lanes over output columns: both H products of all D
//   domains read H from its slot (each element once, applied to all D
//   vectors), and the warp frees the slot; a warp owns a slot and takes its
//   rows in order, and warps never wait on each other, only on their slot's
//   barrier.
// - Final form: no tiles and no barriers: a warp a row, the row's own
//   domain's input, blocks (lanes over columns), head and sigmoid. Domain
//   ids are read as int64 or int32.
// Rows never mix (a NaN stays in its row); the ragged last tile is masked.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <math.h>

#include "mma_ring.cuh"

namespace {

using namespace ring;

constexpr int kMaxH = kWarps;     // slots of the H ring: one a compute warp at most
constexpr int kMinH = 2;
constexpr int kBarBytes = 256;    // full and empty barriers of the weight and the H ring,
                                  // and one for the adapter's matrices
static_assert(16 * (kRing + kMaxH) + 8 <= kBarBytes, "two 8-byte barriers a slot, and one");
constexpr int kAdapterSpans = 6;  // u_down, v_down, b_down, u_up, v_up, b_up
constexpr int kDomainChunk = 8;   // domains whose vectors one pass over a matrix feeds
constexpr int kFinalWarps = 32;   // final form: a warp a row, up to 32 rows at once

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// the input of domain d at (row, c) after the first segment: the previous
// adapter's norm as an affine, plus the residual
__device__ __forceinline__ float affine_in(const float* x, const float* t_pre, const float* mean,
                                           const float* scale, const float* shift, int D, int F,
                                           int row, int d, int c) {
  const size_t g = (static_cast<size_t>(row) * D + d) * F + c;
  const int dc = d * F + c;
  return (__ldg(t_pre + g) - __ldg(mean + dc)) * __ldg(scale + dc) + __ldg(shift + dc) +
         __ldg(x + g);
}

// put(i, get(i)) for every i < n, by `threads` threads from `tid`: each
// thread computes kBatch values (their loads in flight together) before it
// stores any
template <int kBatch, class T, class Get, class Put>
__device__ __forceinline__ void batched(int n, int tid, int threads, Get get, Put put) {
  for (int i0 = tid; i0 < n; i0 += kBatch * threads) {
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * threads;
      if (i < n) v[b] = get(i);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * threads;
      if (i < n) put(i, v[b]);
    }
  }
}

struct Args {
  const float* x;       // emb [B, F] (first) or h_res [B, D, F]
  const float* t_pre;   // [B, D, F] or null (first)
  const float* mean;    // [D, F] or null (first)
  const float* scale;   // [D, F] or null (first)
  const float* shift;   // [D, F] or null (first)
  const float* hyper;   // [B, k, k]
  // the adapter's u_down [w_out, k], v_down [k, mid], b_down [mid], u_up
  // [mid, k], v_up [k, w_out], b_up [w_out]: their floats, and where their
  // copies start in phase 2 (each (address mod 16) / 4 floats further)
  const float* ad[kAdapterSpans];
  int n_ad[kAdapterSpans];
  int o_ad[kAdapterSpans];
  float* out_t;         // [B, D, w_out] the adapter's output before its norm
  float* out_h;         // [B, D, w_out] the blocks' output
  int B, F, D, first, k, mid, w_out;
  int ld_x, ld_a, ld_b;  // phase 1's row strides: input tiles, even and odd layers' outputs
  int ldw, ldk, ldm;     // phase 2's: the h rows, the warps' [D, k] and [D, mid] vectors
  int slot;              // floats of a weight ring slot
  int n_h, hslot;        // H ring slots, floats of one
  int scr;               // floats of a warp's scratch
  // offsets (floats) into the region the phases share: phase 1 the input
  // tiles at 0, then these; phase 2 the tile's h rows at 0, then these
  int o_a, o_b, o_ring;
  int o_scr, o_hring;
  Stack st;  // the blocks: W [D, in, out], b [D, out]
};

// relu(acc + bias) of a finished chunk into the next layer's input rows, or
// (the last layer: gout) the rows < rows and columns < N to gout[r * gld + c].
// Resets the accumulators.
template <int MT>
__device__ __forceinline__ void epilogue(float (&acc)[MT][kNTW][4], int nt, int c0, int N,
                                         const float (&bias)[kNTW][2], float* out, int ldo,
                                         float* gout, int gld, int rows, int warp, int g,
                                         int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nt) {
      const int col = c0 + j * 8 + 2 * t;
      const float b0 = bias[i][0], b1 = bias[i][1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          const int r = m * 16 + g + 8 * h;
          const float v0 = relu(acc[m][i][2 * h] + b0);
          const float v1 = relu(acc[m][i][2 * h + 1] + b1);
          if (gout == nullptr) {
            *reinterpret_cast<float2*>(out + r * ldo + col) = make_float2(v0, v1);
          } else if (r < rows) {
            if (col < N) gout[static_cast<size_t>(r) * gld + col] = v0;
            if (col + 1 < N) gout[static_cast<size_t>(r) * gld + col + 1] = v1;
          }
          acc[m][i][2 * h] = 0.f;
          acc[m][i][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

// The producer warp's part for one span (a row's H, an adapter matrix): n
// floats from src into shared memory at dst, starting (src mod 16 bytes) / 4
// floats into it (dst has 4 floats to spare), so that the 16-byte
// aligned middle of the span lands 16-byte aligned: one bulk copy, whose
// bytes lane 0 announces with its arrival; the ragged ends (up to 3 floats
// each) by cp.async of 4 bytes from lanes 1-6, every lane but 0 arriving
// when its copies have landed.
__device__ __forceinline__ void issue_span(float* to, const float* src, int n, uint32_t full,
                                           int lane) {
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
  const int head = min(n, (4 - off) & 3);
  const int body = (n - head) & ~3;
  const int tail = n - head - body;
  const uint32_t dst = smem_addr(to + off);
  // earlier reads of this memory (generic proxy) before the copies' writes (async)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) bar_arrive_tx(full, static_cast<uint32_t>(body * 4));
  __syncwarp();
  if (lane == 0) {
    if (body > 0) bulk_row(dst + 4u * head, src + head, static_cast<uint32_t>(body * 4), full);
    return;
  }
  if (lane <= head) {
    cp_async4(dst + 4u * (lane - 1), src + lane - 1, true);
  } else if (lane >= 4 && lane < 4 + tail) {
    const int q = head + body + lane - 4;
    cp_async4(dst + 4u * q, src + q, true);
  }
  bar_arrive_cp_async(full);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// The adapter's products, a warp at a time: y[d * ldy + j] = act(sum_l
// x[d * ldx + l] m[l * n + j] + b[j]) for kD vectors x (shared memory) and a
// matrix m [L, n] (shared memory); act: identity, or the sigmoid. Each
// element of m is read once and applied to all kD vectors. x and its row
// stride ldx are 16-byte aligned: 4 elements of a vector a load.
//
// Columns j0 + lane + 32 s, s < kJ: a lane's kJ columns in one pass over m.
// A lane past the last column reads the last one (valid memory, every load
// unconditional) and stores nothing.
template <int kD, int kJ>
__device__ __forceinline__ void cols(uint32_t x, int ldx, int L, uint32_t m, int n,
                                     const float* b, bool sig, float* y, int ldy, int j0,
                                     int lane) {
  float acc[kJ][kD];
#pragma unroll
  for (int s = 0; s < kJ; ++s)
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[s][d] = 0.f;
  uint32_t mj[kJ];
#pragma unroll
  for (int s = 0; s < kJ; ++s) mj[s] = m + 4u * min(j0 + lane + 32 * s, n - 1);
  int l = 0;
#pragma unroll 1
  for (; l + 4 <= L; l += 4) {
    float4 xv[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) xv[d] = lds4(x + 4u * (d * ldx + l));
#pragma unroll
    for (int s = 0; s < kJ; ++s) {
      const uint32_t a = mj[s] + 4u * l * n;
      const float m0 = lds(a), m1 = lds(a + 4u * n), m2 = lds(a + 8u * n), m3 = lds(a + 12u * n);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        acc[s][d] = fmaf(xv[d].x, m0, acc[s][d]);
        acc[s][d] = fmaf(xv[d].y, m1, acc[s][d]);
        acc[s][d] = fmaf(xv[d].z, m2, acc[s][d]);
        acc[s][d] = fmaf(xv[d].w, m3, acc[s][d]);
      }
    }
  }
  for (; l < L; ++l) {
    float xv[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) xv[d] = lds(x + 4u * (d * ldx + l));
#pragma unroll
    for (int s = 0; s < kJ; ++s) {
      const float v = lds(mj[s] + 4u * l * n);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[s][d] = fmaf(xv[d], v, acc[s][d]);
    }
  }
#pragma unroll
  for (int s = 0; s < kJ; ++s) {
    const int j = j0 + lane + 32 * s;
    if (j < n) {
      const float bj = b != nullptr ? b[j] : 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const float v = acc[s][d] + bj;
        y[d * ldy + j] = sig ? sigmoid(v) : v;
      }
    }
  }
}

// One function a domain count, for all six products: a row's chain runs the
// same compact code six times. Up to 128 columns a pass over m.
template <int kD>
__device__ __noinline__ void vecs_times(uint32_t x, int ldx, int L, uint32_t m, int n,
                                        const float* b, bool sig, float* y, int ldy, int lane) {
  for (int j0 = 0; j0 < n; j0 += 128) {
    switch ((min(n - j0, 128) + 31) / 32) {
      case 1: cols<kD, 1>(x, ldx, L, m, n, b, sig, y, ldy, j0, lane); break;
      case 2: cols<kD, 2>(x, ldx, L, m, n, b, sig, y, ldy, j0, lane); break;
      case 3: cols<kD, 3>(x, ldx, L, m, n, b, sig, y, ldy, j0, lane); break;
      default: cols<kD, 4>(x, ldx, L, m, n, b, sig, y, ldy, j0, lane); break;
    }
  }
}

// vecs_times over D vectors, kDomainChunk at a time
__device__ __forceinline__ void times(const float* x, int ldx, int L, const float* m, int n,
                                      const float* b, bool sig, float* y, int ldy, int D,
                                      int lane) {
  for (int d0 = 0; d0 < D; d0 += kDomainChunk) {
    const uint32_t xd = smem_addr(x + d0 * ldx), ms = smem_addr(m);
    float* yd = y + d0 * ldy;
    switch (min(kDomainChunk, D - d0)) {
      case 1: vecs_times<1>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 2: vecs_times<2>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 3: vecs_times<3>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 4: vecs_times<4>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 5: vecs_times<5>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 6: vecs_times<6>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      case 7: vecs_times<7>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
      default: vecs_times<8>(xd, ldx, L, ms, n, b, sig, yd, ldy, lane); break;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
hamur_segment_kernel(const __grid_constant__ Args p) {
  constexpr int M = MT * 16;
  extern __shared__ __align__(16) float smem[];
  const uint32_t wfull = smem_addr(smem);  // [kRing] the weight slot has landed
  const uint32_t wempty = wfull + 8 * kRing;  // [kRing] ... has been read
  const uint32_t hfull = wempty + 8 * kRing;  // [kMaxH] the H slot has landed
  const uint32_t hempty = hfull + 8 * kMaxH;  // [kMaxH] ... has been read
  const uint32_t abar = hempty + 8 * kMaxH;    // the adapter's matrices have landed
  float* u = smem + kBarBytes / 4;  // the region both phases use

  const int D = p.D, W = p.w_out, k = p.k, kk = p.k * p.k;
  const int row0 = blockIdx.x * M;
  const int rows = min(M, p.B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool blocks = p.st.n > 0;

  if (threadIdx.x < kRing) {
    bar_init(wfull + 8 * threadIdx.x, 32);       // the producer warp's lanes
    bar_init(wempty + 8 * threadIdx.x, kWarps);  // a lane of each compute warp
  }
  if (threadIdx.x < p.n_h) {
    bar_init(hfull + 8 * threadIdx.x, 32);
    bar_init(hempty + 8 * threadIdx.x, 1);  // the warp that took the row
  }
  if (threadIdx.x == 0) bar_init(abar, 32 * kAdapterSpans);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // 1. the input: with blocks, the tile(s) the first layer reads; without,
  //    straight to out_h. Rows past the batch and pad columns read a valid
  //    element and are set to zero, so that every load of a batch is issued
  //    unconditionally.
  const int tid = threadIdx.x;
  const int F = p.F, ld_x = p.ld_x, last = rows - 1;
  if (blocks) {
    if (p.first && (F & 3) == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0) {
      const int q4 = ld_x / 4;
      batched<4, float4>(
          M * q4, tid, kThreads,
          [&](int i) {
            const int r = i / q4, c = 4 * (i % q4);
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                p.x + static_cast<size_t>(row0 + min(r, last)) * F + min(c, F - 4)));
            return r < rows && c < F ? v : make_float4(0.f, 0.f, 0.f, 0.f);
          },
          [&](int i, float4 v) { reinterpret_cast<float4*>(u)[i] = v; });
    } else if (p.first) {
      batched<8, float>(
          M * ld_x, tid, kThreads,
          [&](int i) {
            const int r = i / ld_x, c = i % ld_x;
            const float v = __ldg(p.x + static_cast<size_t>(row0 + min(r, last)) * F + min(c, F - 1));
            return r < rows && c < F ? v : 0.f;
          },
          [&](int i, float v) { u[i] = v; });
    } else {
      batched<8, float>(
          D * M * ld_x, tid, kThreads,
          [&](int i) {
            const int c = i % ld_x, r = (i / ld_x) % M, d = i / (M * ld_x);
            const float v = affine_in(p.x, p.t_pre, p.mean, p.scale, p.shift, D, F,
                                      row0 + min(r, last), d, min(c, F - 1));
            return r < rows && c < F ? v : 0.f;
          },
          [&](int i, float v) { u[i] = v; });
    }
  } else {  // a middle segment without blocks (a first one always has blocks)
    batched<8, float>(
        rows * D * W, tid, kThreads,
        [&](int i) {
          return affine_in(p.x, p.t_pre, p.mean, p.scale, p.shift, D, F, row0 + i / (D * W),
                           (i / W) % D, i % W);
        },
        [&](int i, float v) { p.out_h[static_cast<size_t>(row0) * D * W + i] = v; });
  }
  __syncthreads();

  if (warp == kWarps) {
    // 2p. the producer warp: the blocks' weights, slab by slab, through the
    //     weight ring; once every slab has been read (phase 1's memory is
    //     free), each row's H through the H ring
    int s = 0;
    if (blocks) {
      Slab prod = {0, 0, 0, 0};
      for (; prod.e < D; ++s) {
        const int slot = s % kRing;
        bar_wait(wempty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
        issue_slab(p.st, prod, u + p.o_ring + slot * p.slot, wfull + 8 * slot, lane);
        advance(p.st, prod);
      }
      for (int j = s > kRing ? s - kRing : 0; j < s; ++j)
        bar_wait(wempty + 8 * (j % kRing), (j / kRing) & 1);
    }
    for (int j = 0; j < kAdapterSpans; ++j)
      issue_span(u + p.o_ad[j], p.ad[j], p.n_ad[j], abar, lane);
    for (int i = 0; i < rows; ++i) {
      const int hs = i % p.n_h;
      bar_wait(hempty + 8 * hs, ((i / p.n_h) & 1) ^ 1);
      issue_span(u + p.o_hring + hs * p.hslot, p.hyper + static_cast<size_t>(row0 + i) * kk, kk,
                 hfull + 8 * hs, lane);
    }
    // no copy of this warp's left in flight when it exits: the last rows read
    for (int i = rows > p.n_h ? rows - p.n_h : 0; i < rows; ++i)
      bar_wait(hempty + 8 * (i % p.n_h), (i / p.n_h) & 1);
    return;
  }

  if (blocks) {
    // 2. every domain's blocks, layer by layer, from the weight ring
    float* xs = u;
    float* buf_a = u + p.o_a;  // even layers' outputs
    float* buf_b = u + p.o_b;  // odd layers' outputs
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;
    float bias[kNTW][2];
    Slab cons = {0, 0, 0, 0};
    for (int s = 0; cons.e < D; ++s) {
      const int slot = s % kRing;
      const int l = cons.l, K = p.st.dim[l], N = p.st.dim[l + 1];
      const float* A = l == 0 ? xs + (p.first ? 0 : cons.e * M * p.ld_x)
                              : ((l & 1) ? buf_a : buf_b);
      const int lda = l == 0 ? p.ld_x : ((l & 1) ? p.ld_a : p.ld_b);
      const int c0 = cons.c * kChunk;
      const int nt = (min(kChunk, N - c0) + 7) / 8;
      if (cons.k0 == 0)
        load_bias(bias, p.st.b[l] + static_cast<size_t>(cons.e) * N, nt, c0, N, warp, t);
      bar_wait(wfull + 8 * slot, (s / kRing) & 1);  // slab s has landed
      mma_slab<MT>(A, lda, cons.k0, K, p.st.srows[l], u + p.o_ring + slot * p.slot,
                   p.st.sld[l], nt, acc, warp, g, t);
      __syncwarp();
      if (lane == 0) bar_arrive(wempty + 8 * slot);  // this warp is done with the slot
      if (cons.k0 + p.st.srows[l] >= K) {  // the chunk is done
        const bool last = l == p.st.n - 1;
        epilogue<MT>(acc, nt, c0, N, bias, (l & 1) ? buf_b : buf_a, (l & 1) ? p.ld_b : p.ld_a,
                     last ? p.out_h + (static_cast<size_t>(row0) * D + cons.e) * W : nullptr,
                     D * W, rows, warp, g, t);
        compute_sync();  // its output, before the next layer reads it
      }
      advance(p.st, cons);
    }
  }
  compute_sync();  // phase 1 done in every compute warp: out_h's rows are written

  // 3. phase 2: the tile's h rows, read back from out_h (plain loads: this
  //    launch wrote them), while the producer copies the adapter's matrices
  const int mid = p.mid, ldw = p.ldw, ldk = p.ldk, ldm = p.ldm;
  float* hts = u;  // [rows, D, ldw]
  const float* hsrc = p.out_h + static_cast<size_t>(row0) * D * W;
  if ((W & 3) == 0) {  // ldw == W, rows of 16-byte multiples
    batched<4, float4>(
        rows * D * W / 4, tid, kComputeThreads,
        [&](int i) { return reinterpret_cast<const float4*>(hsrc)[i]; },
        [&](int i, float4 v) { reinterpret_cast<float4*>(hts)[i] = v; });
  } else {
    batched<8, float>(
        rows * D * W, tid, kComputeThreads, [&](int i) { return hsrc[i]; },
        [&](int i, float v) { hts[i / W * ldw + i % W] = v; });
  }
  compute_sync();
  bar_wait(abar, 0);
  const float* mat[kAdapterSpans];
  for (int j = 0; j < kAdapterSpans; ++j)
    mat[j] = u + p.o_ad[j] + ((reinterpret_cast<uintptr_t>(p.ad[j]) & 15) >> 2);

  // 4. the adapter, a row per warp at a time, its H from the H ring. Warp w
  //    owns slot w and takes its rows w, w + n_h, ... in order, so a slot's
  //    full barrier is never waited on two phases ahead; warps past n_h have
  //    no rows.
  float* P = u + p.o_scr + warp * p.scr;  // [D, ldk]
  float* Q = P + D * ldk;                 // [D, ldk]
  float* T = Q + D * ldk;                 // [D, ldm]
  for (int i = warp; warp < p.n_h && i < rows; i += p.n_h) {
    const int hs = i % p.n_h;
    const float* src = p.hyper + static_cast<size_t>(row0 + i) * kk;
    const float* H = u + p.o_hring + hs * p.hslot + ((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    times(hts + i * D * ldw, ldw, W, mat[0], k, nullptr, false, P, ldk, D, lane);
    __syncwarp();
    bar_wait(hfull + 8 * hs, (i / p.n_h) & 1);  // row i's H has landed
    times(P, ldk, k, H, k, nullptr, false, Q, ldk, D, lane);
    __syncwarp();
    times(Q, ldk, k, mat[1], mid, mat[2], true, T, ldm, D, lane);
    __syncwarp();
    times(T, ldm, mid, mat[3], k, nullptr, false, P, ldk, D, lane);
    __syncwarp();
    times(P, ldk, k, H, k, nullptr, false, Q, ldk, D, lane);
    __syncwarp();
    if (lane == 0) bar_arrive(hempty + 8 * hs);  // the warp is done with the slot
    times(Q, ldk, k, mat[4], W, mat[5], false, p.out_t + static_cast<size_t>(row0 + i) * D * W, W,
          D, lane);
  }
}

struct FinalArgs {
  const float* x;       // emb [B, F] (first) or h_res [B, D, F]
  const float* t_pre;   // [B, D, F] or null (first)
  const float* mean;
  const float* scale;
  const float* shift;
  const void* did;      // [B], int64 when id64, else int32
  float* out;           // [B] probs
  int id64, B, F, D, first, tb, ld;  // ld: a warp's buffer stride
  int n;                             // stages: the blocks, then the head (width 1)
  int dim[kMaxStages + 2];
  const float* w[kMaxStages + 1];    // W [D, in, out]
  const float* b[kMaxStages + 1];    // b [D, out]
};

// The final form: a warp a row, no block barriers.
__global__ void __launch_bounds__(32 * kFinalWarps)
hamur_final_kernel(const __grid_constant__ FinalArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* a = smem + static_cast<size_t>(warp) * 2 * p.ld;
  float* b = a + p.ld;
  const int end = min(p.B, (blockIdx.x + 1) * p.tb);
  for (int r = blockIdx.x * p.tb + warp; r < end; r += blockDim.x / 32) {
    // an int64 id is taken modulo 2^32 as an int32, then clipped, as the
    // plain version and the reference (int32 ids) take it
    int d = p.id64 ? static_cast<int>(static_cast<const long long*>(p.did)[r])
                   : static_cast<const int*>(p.did)[r];
    d = d < 0 ? 0 : (d >= p.D ? p.D - 1 : d);
    for (int c = lane; c < p.F; c += 32)
      a[c] = p.first ? __ldg(p.x + static_cast<size_t>(r) * p.F + c)
                     : affine_in(p.x, p.t_pre, p.mean, p.scale, p.shift, p.D, p.F, r, d, c);
    __syncwarp();
    for (int s = 0; s + 1 < p.n; ++s) {
      const int K = p.dim[s], N = p.dim[s + 1];
      const float* w = p.w[s] + static_cast<size_t>(d) * K * N;
      const float* bias = p.b[s] + static_cast<size_t>(d) * N;
      for (int j = lane; j < N; j += 32) {
        float acc = 0.f;
        for (int c = 0; c < K; ++c) acc = fmaf(a[c], __ldg(w + static_cast<size_t>(c) * N + j), acc);
        b[j] = relu(acc + __ldg(bias + j));
      }
      __syncwarp();
      float* tmp = a;
      a = b;
      b = tmp;
    }
    const int K = p.dim[p.n - 1];
    const float* w = p.w[p.n - 1] + static_cast<size_t>(d) * K;
    float part = 0.f;
    for (int c = lane; c < K; c += 32) part = fmaf(a[c], __ldg(w + c), part);
    part = warp_sum(part);
    if (lane == 0) p.out[r] = sigmoid(part + __ldg(p.b[p.n - 1] + d));
    __syncwarp();  // before the next row overwrites a
  }
}

// The first and middle forms' shared memory for a tb-row tile within
// `budget` bytes: phase 1 (the input tiles, the activations, the weight
// ring) and phase 2 (the tile's h rows, the adapter's matrices, the warps'
// scratch, the H ring) share one region. The weight ring takes what phase 1
// leaves, up to kRing slots of kSlotFloats and at least 8 weight rows of each
// layer a slot; the H ring what phase 2 leaves, kMinH to kMaxH slots.
// `bytes` is over the budget when even the smallest rings do not fit.
struct Layout {
  int ld_x, ld_a, ld_b, ldw, ldk, ldm, slot, n_h, hslot, scr;
  int o_a, o_b, o_ring, o_ad[kAdapterSpans], o_scr, o_hring;
  size_t bytes;
  Stack st;
};

Layout layout(int tb, int F, int D, int first, int w_out, int k, int mid, const Stack& st,
              size_t budget) {
  Layout L = {};
  L.st = st;
  const int n = st.n;
  int wa = 0, wb = 0;  // widths of the layers before the last (the last goes to out_h)
  for (int l = 0; l + 1 < n; ++l) {
    const int w = st.dim[l + 1];
    if (l & 1) wb = w > wb ? w : wb;
    else wa = w > wa ? w : wa;
  }
  L.ld_x = ld_act(F);
  L.ld_a = wa > 0 ? ld_act(wa) : 0;
  L.ld_b = wb > 0 ? ld_act(wb) : 0;
  const int min_slot = n > 0 ? slab_strides(L.st) : 0;
  L.o_a = n > 0 ? (first ? 1 : D) * tb * L.ld_x : 0;
  L.o_b = L.o_a + tb * L.ld_a;
  L.o_ring = L.o_b + tb * L.ld_b;
  const long long p1 = n > 0 ? L.o_ring : 0;

  L.hslot = round_up(k * k, 4) + 4;
  L.ldw = round_up(w_out, 4);
  L.ldk = round_up(k, 4);
  L.ldm = round_up(mid, 4);
  L.scr = D * (2 * L.ldk + L.ldm);
  int o = tb * D * L.ldw;
  const int n_ad[kAdapterSpans] = {w_out * k, k * mid, mid, mid * k, k * w_out, w_out};
  for (int j = 0; j < kAdapterSpans; ++j) {  // 4 floats more: the copy's start moves up to 3
    L.o_ad[j] = o;
    o += round_up(n_ad[j], 4) + 4;
  }
  L.o_scr = o; o += kWarps * L.scr;
  L.o_hring = o;
  const long long p2 = o;

  const long long room = (static_cast<long long>(budget) - kBarBytes) / 4;
  if (n > 0) {
    const long long per = (room - p1) / kRing;
    const int slot = static_cast<int>(per < 0 ? 0 : (per < kSlotFloats ? per : kSlotFloats)) & ~3;
    L.slot = slot < min_slot ? min_slot : slot;  // past the budget when it is too small
    fill_slabs(L.st, L.slot);
  }
  const long long nh = (room - p2) / L.hslot;
  L.n_h = static_cast<int>(nh < kMinH ? kMinH : (nh > kMaxH ? kMaxH : nh));
  const long long a = p1 + static_cast<long long>(kRing) * L.slot;
  const long long b = p2 + static_cast<long long>(L.n_h) * L.hslot;
  L.bytes = kBarBytes + 4 * static_cast<size_t>(a > b ? a : b);
  return L;
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(hamur_segment_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  hamur_segment_kernel<MT><<<(p.B + MT * 16 - 1) / (MT * 16), kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

cudaError_t launch_final(const FinalArgs& p, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(hamur_final_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  hamur_final_kernel<<<(p.B + p.tb - 1) / p.tb, threads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x, t_pre, mean, scale, shift, hyper: as Args (null where the form has none);
// adapter: a host array of 6 device pointers u_down, v_down, b_down, u_up,
// v_up, b_up (ignored in the final form); did: [B] domain ids (the final
// form), int64 when id64, else int32. w_ptrs/b_ptrs: host arrays of device
// pointers, one per stage, the block stages then (final) the head; dims:
// (K, N) per stage. block_rows: rows of one block, a multiple of 16 up to 64,
// or 0: 32 where a 32-row tile fits in shared memory, else 16. Writes the
// dynamic shared memory a block takes (or would take) to *smem_bytes.
// Returns a cudaError_t.
int hamur_segment_f32(const void* x, const void* t_pre, const void* mean, const void* scale,
                      const void* shift, const void* hyper, const void* adapter,
                      const void* did, int id64, void* out_t, void* out_h, void* out_p, int B,
                      int F, int D, int k, int mid, int first, int final_, int n_st,
                      const void* w_ptrs, const void* b_ptrs, const void* dims, int block_rows,
                      void* stream, size_t* smem_bytes) {
  const int n = n_st + (final_ ? 1 : 0);
  *smem_bytes = 0;
  if (B < 0 || F < 1 || D < 1 || n_st < 0 || n_st > kMaxStages || block_rows < 0 ||
      block_rows % 16 != 0 || block_rows > 16 * kMaxMT)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* wp = static_cast<const float* const*>(w_ptrs);
  const float* const* bp = static_cast<const float* const*>(b_ptrs);
  const int* kn = static_cast<const int*>(dims);
  int width = F;
  for (int s = 0; s < n; ++s) {
    if (kn[2 * s] != width || kn[2 * s + 1] < 1) return static_cast<int>(cudaErrorInvalidValue);
    width = kn[2 * s + 1];
  }
  if (final_ ? width != 1 : (k < 1 || mid < 1)) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);

  if (final_) {
    FinalArgs p = {};
    p.x = static_cast<const float*>(x);
    p.t_pre = static_cast<const float*>(t_pre);
    p.mean = static_cast<const float*>(mean);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.did = did;
    p.out = static_cast<float*>(out_p);
    p.id64 = id64; p.B = B; p.F = F; p.D = D; p.first = first ? 1 : 0; p.n = n;
    p.tb = block_rows > 0 ? block_rows : 32;
    int wmax = F;
    for (int s = 0; s < n; ++s) {
      p.w[s] = wp[s];
      p.b[s] = bp[s];
      p.dim[s] = kn[2 * s];
      wmax = kn[2 * s + 1] > wmax ? kn[2 * s + 1] : wmax;
    }
    p.dim[n] = 1;
    p.ld = round_up(wmax, 4);
    const int warps = p.tb < kFinalWarps ? p.tb : kFinalWarps;
    const size_t smem = static_cast<size_t>(warps) * 2 * p.ld * sizeof(float);
    *smem_bytes = smem;
    if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return static_cast<int>(cudaSuccess);
    err = launch_final(p, 32 * warps, smem, strm);
  } else {
    Stack st = {};
    st.n = n_st;
    st.dim[0] = F;
    for (int s = 0; s < n_st; ++s) {
      st.dim[s + 1] = kn[2 * s + 1];
      st.w[s] = wp[s];
      st.b[s] = bp[s];
    }
    const int w_out = st.dim[n_st];
    if (block_rows == 0)
      block_rows = layout(32, F, D, first, w_out, k, mid, st, budget).bytes <= budget ? 32 : 16;
    const Layout L = layout(block_rows, F, D, first, w_out, k, mid, st, budget);
    *smem_bytes = L.bytes;
    if (L.bytes > budget) return static_cast<int>(cudaErrorInvalidValue);
    Args p = {};
    p.x = static_cast<const float*>(x);
    p.t_pre = static_cast<const float*>(t_pre);
    p.mean = static_cast<const float*>(mean);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.hyper = static_cast<const float*>(hyper);
    const float* const* a = static_cast<const float* const*>(adapter);
    const int n_ad[kAdapterSpans] = {w_out * k, k * mid, mid, mid * k, k * w_out, w_out};
    for (int j = 0; j < kAdapterSpans; ++j) {
      p.ad[j] = a[j];
      p.n_ad[j] = n_ad[j];
      p.o_ad[j] = L.o_ad[j];
    }
    p.out_t = static_cast<float*>(out_t);
    p.out_h = static_cast<float*>(out_h);
    p.B = B; p.F = F; p.D = D; p.first = first ? 1 : 0; p.k = k; p.mid = mid; p.w_out = w_out;
    p.ld_x = L.ld_x; p.ld_a = L.ld_a; p.ld_b = L.ld_b;
    p.ldw = L.ldw; p.ldk = L.ldk; p.ldm = L.ldm;
    p.slot = L.slot; p.n_h = L.n_h; p.hslot = L.hslot; p.scr = L.scr;
    p.o_a = L.o_a; p.o_b = L.o_b; p.o_ring = L.o_ring;
    p.o_scr = L.o_scr; p.o_hring = L.o_hring;
    p.st = L.st;
    if (B == 0) return static_cast<int>(cudaSuccess);
    switch (block_rows / 16) {
      case 1: err = launch<1>(p, L.bytes, strm); break;
      case 2: err = launch<2>(p, L.bytes, strm); break;
      case 3: err = launch<3>(p, L.bytes, strm); break;
      default: err = launch<4>(p, L.bytes, strm); break;
    }
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
