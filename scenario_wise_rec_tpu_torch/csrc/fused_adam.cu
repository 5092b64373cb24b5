// Exact dense torch-Adam over a whole [V, D] embedding table from the batch's
// per-occurrence gradient rows in their original order, the ids sorted within
// each segment. In place on table, mu and nu.
//
// Replaces the TPU kernel
//   scenario_wise_rec_tpu/ops/pallas/fused_adam.py:96 fused_dense_adam_apply
// (pallas_call :149; its body `_kernel`, :41-93). Same function as
// csrc/sorted_adam.cu, from other inputs: the gradient rows g [K, D] stay in
// the order the backward produced them and each sorted position p reads its
// row through sorted_pos[p]; the ids are sorted within each of S segments
// (one per feature), not globally, so a vocab tile merges S sorted spans.
// Every table row, touched or not, takes the Adam step of
// csrc/embedding_adam.cuh; ids outside [0, V) contribute nothing.
//
// Bound: bytes, as csrc/sorted_adam.cu: every row of table, mu and nu read and
// written once (6 * V * D * 4 bytes; 4.12 GB at the Ali-CCP shape, V =
// 10,741,000, D = 16) plus the K ids, K positions and K gradient rows. At
// 3.35 TB/s that is ~1.23 ms.
//
// Design (not the TPU's: there a single sequential program walks each
// segment's ids with a scalar loop and rotates each gradient row into its
// lane slot of a packed [block_rows / r, 128] accumulator):
//   1. `tile_starts_kernel`: for every segment and every tile boundary, a
//      binary search into the segment's sorted span, all in parallel
//      (starts [S * (NB + 1)], the caller's scratch, the layout of the JAX
//      kernel's `starts`).
//   2. `dense_adam_kernel`, one block per tile of `block_rows` rows: the
//      block reads its tile's S span bounds into shared memory at once (read
//      one at a time inside the segment loop, they cost 0.37 ms a call at
//      the Ali-CCP shape's 84k tiles of 128 rows on an H100; PERF.md);
//      then for each segment in turn, its span of the tile is staged with
//      the gradient rows gathered through sorted_pos, and summed into the
//      tile's shared accumulator by a segmented warp scan per column (a hot
//      row's thousands of duplicates are summed 32 positions per step by
//      every warp). Then the block streams Adam over the whole tile. No row is
//      shared with another block: no atomics, and the order of every sum is
//      fixed by the data.
//
// The 7 Adam numbers come by value (`fused_dense_adam_f32`) or from a [7] f32
// array in device memory (`fused_dense_adam_f32_dev`), the form a CUDA graph
// of the train step replays, as csrc/sorted_adam.cu's `_dev` forms.
//
// Plain C interface (no PyTorch headers), built with nvcc for sm_90a and
// loaded with ctypes (ops/kernels/_build.py). The kernels run on the caller's
// stream and allocate nothing.

#include "embedding_adam.cuh"

extern "C" {

// Dynamic shared memory one block of the Adam kernel needs for nseg segments.
size_t fused_dense_adam_smem_bytes(int d, int block_rows, int nseg) {
  return emb_adam::smem_bytes(d, block_rows, nseg);
}

// table, mu, nu: [v, d] f32, updated in place. g: [k, d] f32 gradient rows in
// their original order. ids: [k] int32, ascending within each segment s, the
// positions [seg_off[s], seg_off[s + 1]); pos: [k] int32, the row of g of
// each sorted position. seg_off: [nseg + 1] int32 on the device. starts:
// [nseg * (ceil(v / block_rows) + 1)] int32 scratch. Returns
// cudaGetLastError() after the launches (0 = success).
int fused_dense_adam_f32(float* table, float* mu, float* nu, const float* g,
                         const int* ids, const int* pos, const int* seg_off,
                         int nseg, int* starts, long long v, int d, int k,
                         int block_rows, float lr, float wd, float b1, float b2,
                         float bc1r, float bc2r, float eps, void* stream) {
  const emb_adam::Hp h{lr, wd, b1, b2, bc1r, bc2r, eps};
  return emb_adam::launch(table, mu, nu, ids, pos, g, seg_off, nseg, starts, v, d,
                          k, block_rows, h, stream);
}

// The same, the Adam numbers read from hp: [7] f32 in device memory, (lr, wd,
// b1, b2, bc1r, bc2r, eps), each block loading them once. A CUDA graph that
// captures this launch reads whatever hp holds at each replay.
int fused_dense_adam_f32_dev(float* table, float* mu, float* nu, const float* g,
                             const int* ids, const int* pos, const int* seg_off,
                             int nseg, int* starts, long long v, int d, int k,
                             int block_rows, const float* hp, void* stream) {
  const emb_adam::Hp h{};
  return emb_adam::launch(table, mu, nu, ids, pos, g, seg_off, nseg, starts, v, d,
                          k, block_rows, h, stream, hp);
}

}  // extern "C"
