// What mmoe_infer.cu and hamur_infer.cu share on NVIDIA Hopper (sm_90a): a
// stack of dense relu layers run on the tensor cores in 3xTF32, its weights
// streamed by a producer warp through a ring of shared-memory slots.
//
// - 3xTF32: each f32 operand x is split into hi (x's top 10 mantissa bits,
//   a TF32 value) and lo = x - hi; a product is hi*hi + hi*lo + lo*hi, three
//   mma.sync.m16n8k8 TF32 products accumulated in f32 (the lo*lo term, ~2^-20
//   relative, is dropped), so the f32 tolerances hold.
// - The ring: a producer warp copies one layer's W [K, N] of one member of
//   the stack (an expert, a domain) slab by slab into kRing slots (a slab:
//   as many weight rows as fill a slot, by up to kChunk columns), one bulk
//   async copy a row (cp.async.bulk, completing on the slot's full barrier;
//   cp.async where rows are not 8-float multiples), as far ahead as the
//   kWarps compute warps free slots (the empty barriers). The compute warps
//   never issue a copy and meet only at a layer's end.
// - A compute warp owns every 16-row m-tile of the block and the n-tiles
//   j = warp + kWarps i of a chunk, so each weight element is read from
//   shared memory once per block, and one A fragment feeds kNTW n-tiles x 3
//   products. Activations keep a row stride of 4 mod 32 floats (ld_act) and
//   weight slabs 8 mod 32 (ld_slab), so the fragment loads are free of bank
//   conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ring {

constexpr int kMaxStages = 8;     // layers of a stack
constexpr int kWarps = 8;         // compute warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kComputeThreads = 32 * kWarps;
constexpr int kSlotFloats = 9216; // a ring slot: up to 36 KB of one layer's weight rows
constexpr int kChunk = 256;       // output columns per pass over a layer
constexpr int kRing = 3;          // slots: slabs in flight and in use
constexpr int kNTW = kChunk / 8 / kWarps;  // n-tiles of a chunk per warp
constexpr int kMaxMT = 4;         // 16-row m-tiles per block: block_rows <= 64

// A stack of n relu layers with `members` members (weights W [members, K, N]).
struct Stack {
  int n;
  int dim[kMaxStages + 1];     // the input width, then each layer's output width
  int srows[kMaxStages];       // layer l: weight rows a slab (a multiple of 8)
  int sld[kMaxStages];         //          and their stride in the slot
  const float* w[kMaxStages];  //          W [members, dim[l], dim[l + 1]]
  const float* b[kMaxStages];  //          b [members, dim[l + 1]]
};

// where the ring's producer or consumer stands: member e, layer l, output
// chunk c, first weight row k0; past the last member when e >= members
struct Slab {
  int e, l, c, k0;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// activation rows: 4 mod 32 floats (A fragments conflict-free)
__host__ __device__ inline int ld_act(int w) { return round_up(w, 32) + 4; }
// weight slab rows of a chunk `wc` wide: 8 mod 32 floats (B fragments
// conflict-free; 16-byte rows for the bulk copies)
__host__ __device__ inline int ld_slab(int wc) { return round_up(wc, 32) + 8; }

// relu that keeps a NaN visible, as max(x, 0) does in XLA
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo exactly: hi keeps x's top 10 mantissa bits (a TF32 value), lo
// = x - hi (|lo| < 2^-10 |x|) goes to the tensor core as it is, which reads
// its TF32 part (10 more bits): hi*hi + hi*lo + lo*hi is within ~2^-20 of
// the product. Two instructions a value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// this thread's arrival, counted when its earlier cp.async copies have landed
__device__ __forceinline__ void bar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one row of a slab, global -> shared, counted on the slot's full barrier
__device__ __forceinline__ void bulk_row(uint32_t dst, const float* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the compute warps only (the producer warp runs ahead on its own)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kComputeThreads) : "memory");
}

__device__ __forceinline__ void advance(const Stack& st, Slab& s) {
  s.k0 += st.srows[s.l];
  if (s.k0 < st.dim[s.l]) return;
  s.k0 = 0;
  if (++s.c * kChunk < st.dim[s.l + 1]) return;
  s.c = 0;
  if (++s.l < st.n) return;
  s.l = 0;
  ++s.e;
}

// The producer warp's part: rows k0 .. k0 + srows - 1 and columns of chunk c
// of member e's layer l into a ring slot [srows, sld]; each lane arrives on the
// slot's full barrier, which completes when the slab has landed. Rows from K
// up to K rounded to 8 and columns from N up to the chunk's width rounded to
// 8 are zero (the mma reads them against zero activations); rows past those
// are never read. Rows of 8-float multiples from 16-byte aligned weights come
// as one bulk copy a row (the async proxy: no registers, a few instructions
// a slab); others as cp.async of 16 or 4 bytes, zero-filled.
__device__ void issue_slab(const Stack& st, const Slab& s, float* slot, uint32_t full, int lane) {
  const int K = st.dim[s.l], N = st.dim[s.l + 1];
  const float* W = st.w[s.l] + static_cast<size_t>(s.e) * K * N;
  const int c0 = s.c * kChunk;
  const int wc = min(kChunk, N - c0);
  const int wc8 = round_up(wc, 8);
  const uint32_t base = smem_addr(slot);
  const int ldw = st.sld[s.l], srows = st.srows[s.l];
  const bool aligned = (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  if ((N & 7) == 0 && aligned) {
    const int rows = min(srows, K - s.k0);
    const int pad = min(srows, round_up(K, 8) - s.k0) - rows;
    for (int i = lane; i < pad * wc; i += 32) slot[(rows + i / wc) * ldw + i % wc] = 0.f;
    // the slot's earlier reads (generic proxy) before the copies' writes (async)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) bar_arrive_tx(full, static_cast<uint32_t>(rows * wc * 4));
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_row(base + 4u * (r * ldw), W + static_cast<size_t>(s.k0 + r) * N + c0,
               static_cast<uint32_t>(wc * 4), full);
    if (lane != 0) bar_arrive(full);
    return;
  }
  const bool vec = (N & 3) == 0 && aligned;
  const int per_row = vec ? wc8 / 4 : wc8;
  for (int i = lane; i < srows * per_row; i += 32) {
    const int r = i / per_row, q = vec ? 4 * (i % per_row) : i % per_row;
    const int k = s.k0 + r;
    const bool ok = k < K && q < wc;
    const float* src = ok ? W + static_cast<size_t>(k) * N + c0 + q : W;
    if (vec)
      cp_async16(base + 4u * (r * ldw + q), src, ok);
    else
      cp_async4(base + 4u * (r * ldw + q), src, ok);
  }
  bar_arrive_cp_async(full);
}

// acc[m][i] += A[m-tile m, k0 .. k0 + rows) x Ws[., n-tile warp + 8 i] in 3xTF32
template <int MT>
__device__ __forceinline__ void mma_slab(const float* A, int lda, int k0, int K, int rows,
                                         const float* Ws, int ldw, int nt,
                                         float (&acc)[MT][kNTW][4], int warp, int g, int t) {
#pragma unroll 4
  for (int kk = 0; kk < rows; kk += 8) {
    if (k0 + kk >= K) break;  // uniform: past the layer's (zero-padded) depth
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a = A + (m * 16 + g) * lda + k0 + kk + t;
      split(a[0], ah[m][0], al[m][0]);
      split(a[8 * lda], ah[m][1], al[m][1]);
      split(a[4], ah[m][2], al[m][2]);
      split(a[8 * lda + 4], ah[m][3], al[m][3]);
    }
    uint32_t bh[kNTW][2], bl[kNTW][2];
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      if (warp + kWarps * i < nt) {
        const float* b = Ws + (kk + t) * ldw + (warp + kWarps * i) * 8 + g;
        split(b[0], bh[i][0], bl[i][0]);
        split(b[4 * ldw], bh[i][1], bl[i][1]);
      }
    }
    // each product over every (m-tile, n-tile) before the next: a chain of
    // dependent mma is MT x kNTW apart
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      if (warp + kWarps * i < nt) {
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i], al[m], bh[i][0], bh[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      if (warp + kWarps * i < nt) {
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i], ah[m], bl[i][0], bl[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      if (warp + kWarps * i < nt) {
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i], ah[m], bh[i][0], bh[i][1]);
      }
    }
  }
}

// This thread's bias pair of each of its n-tiles of a chunk, read when the
// chunk starts so that the epilogue does not wait on L2.
__device__ __forceinline__ void load_bias(float (&bias)[kNTW][2], const float* __restrict__ b,
                                          int nt, int c0, int N, int warp, int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int col = c0 + (warp + kWarps * i) * 8 + 2 * t;
    const bool tile = warp + kWarps * i < nt;
    bias[i][0] = tile && col < N ? __ldg(b + col) : 0.f;
    bias[i][1] = tile && col + 1 < N ? __ldg(b + col + 1) : 0.f;
  }
}

// The smallest ring slot of a stack (8 weight rows of its widest slab), and
// each layer's slab stride; the slab rows come from fill_slabs once the slot
// is sized.
inline int slab_strides(Stack& st) {
  int min_slot = 0;
  for (int l = 0; l < st.n; ++l) {
    const int n = st.dim[l + 1];
    st.sld[l] = ld_slab(n < kChunk ? n : kChunk);
    min_slot = 8 * st.sld[l] > min_slot ? 8 * st.sld[l] : min_slot;
  }
  return min_slot;
}

// a slab: as many rows as fill a slot, so that a narrow layer is one slab
inline void fill_slabs(Stack& st, int slot) {
  for (int l = 0; l < st.n; ++l) {
    st.srows[l] = (slot / st.sld[l]) & ~7;
    st.srows[l] = st.srows[l] < round_up(st.dim[l], 8) ? st.srows[l] : round_up(st.dim[l], 8);
  }
}

}  // namespace ring
